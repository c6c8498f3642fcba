"""Named timing spans, trace annotations and the analytic UNet FLOP count.

Every span is also a ``torch.profiler.record_function`` range, as is each
``trace_annotation``, so a
``torch.profiler`` trace shows the same names.  PyTorch returns before the
card finishes, so ``Timer`` synchronises the calling thread's current CUDA
stream at the end of each span: a span is the time the work took, not the
time it took to enqueue it.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch


@contextlib.contextmanager
def trace_annotation(name: str):
    """A named range of a ``torch.profiler`` trace (the JAX package's
    ``jax.profiler.TraceAnnotation`` wrapper)."""
    with torch.profiler.record_function(name):
        yield


@dataclass
class Timer:
    """Accumulates named wall-clock spans, synchronising the current stream
    of ``device`` (when it is a CUDA device) before each span is opened and
    closed.

    A span is the calling thread's own work: the stream it waits for is
    that thread's current one, not the whole device.  So a request that
    ``One2345Pipeline.run_many`` runs on a stream of its own does not wait
    for another request's kernels; a ``run`` alone issues everything on
    one stream, and there the two are the same."""

    device: torch.device | str | None = None
    spans: dict = field(default_factory=dict)

    def _sync(self):
        if self.device is not None and torch.device(self.device).type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    @contextlib.contextmanager
    def span(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            self.spans[name] = self.spans.get(name, 0.0) + dt

    def report(self) -> dict:
        return dict(self.spans)

    def total(self) -> float:
        return sum(self.spans.values())


def unet_flops_per_eval(batch: int, latent: int = 32) -> float:
    """Analytic matmul/conv FLOPs of ONE Zero123-XL UNet eval (SD-1.x:
    320 base ch, mult (1,2,4,4), 2 res blocks/level, transformer at levels
    0-2 and the middle, S=1 cross-attention context).  Counted from the
    module structure at 2*M*N*K per matmul / 2*HW*Cin*Cout*K^2 per conv;
    elementwise/normalization FLOPs excluded.  Same count as the JAX
    package's ``core/profiling.py``."""
    B, L, ch = batch, latent, 320
    mults = (1, 2, 4, 4)
    f = 0.0

    def conv(cin, cout, hw, k=3):
        return 2.0 * B * hw * hw * cin * cout * k * k

    def dense(cin, cout, tokens):
        return 2.0 * B * tokens * cin * cout

    def transformer(c, hw):
        tokens = hw * hw
        t = 2 * conv(c, c, hw, k=1)                  # proj in/out
        t += 4 * dense(c, c, tokens)                  # self-attn qkv + out
        t += 4.0 * B * tokens * tokens * c            # scores + values
        t += 2 * dense(c, c, tokens)                  # cross-attn q + out
        t += 2 * 2.0 * B * 1 * 768 * c                # cross kv (S=1)
        t += 4.0 * B * tokens * 1 * c                 # cross scores+values
        t += dense(c, 8 * c, tokens) + dense(4 * c, c, tokens)  # GEGLU FF
        return t

    attn_ds = (1, 2, 4)  # attention_resolutions: ds=8 level has none
    f += conv(8, ch, L)  # input conv
    skips = [ch]
    hw, c_prev, ds = L, ch, 1
    for i, m in enumerate(mults):
        c = ch * m
        for _ in range(2):
            f += conv(c_prev, c, hw) + conv(c, c, hw)
            if c_prev != c:
                f += conv(c_prev, c, hw, k=1)
            f += 2.0 * B * 1280 * c  # time-emb dense
            c_prev = c
            if ds in attn_ds:
                f += transformer(c, hw)
            skips.append(c)
        if i != len(mults) - 1:
            hw //= 2
            ds *= 2
            f += conv(c, c, hw)  # stride-2 downsample (output hw)
            skips.append(c)
    # middle (always has a transformer)
    f += 2 * (2 * conv(c_prev, c_prev, hw) + 2.0 * B * 1280 * c_prev)
    f += transformer(c_prev, hw)
    # decoder
    for i, m in reversed(list(enumerate(mults))):
        c = ch * m
        for _ in range(3):
            cin = c_prev + skips.pop()
            f += conv(cin, c, hw) + conv(c, c, hw) + conv(cin, c, hw, k=1)
            f += 2.0 * B * 1280 * c
            c_prev = c
            if ds in attn_ds:
                f += transformer(c, hw)
        if i != 0:
            hw *= 2
            ds //= 2
            f += conv(c, c, hw)  # upsample conv after nearest resize
    f += conv(ch, 4, L)  # out conv
    return f
