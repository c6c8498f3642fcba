"""The benchmark's fixed arithmetic: the H100's peaks, the UNet's operation
count and the flash-attention kernels' bounds.

Frozen copies, so that a later change to the program cannot move the
yardstick it is measured with:

- ``unet_flops_per_eval``: ``one2345_tpu_torch/core/profiling.py``, made
  generic over the UNet's widths (the same count at the published ones:
  176.3 GFLOP per sample per eval at a 32^2 latent);
- ``kernel_bound`` and ``backward_bounds``: ``chip_smoke.py``, with the
  exp unit's rate fixed at 132 SMs x 1980 MHz (the SXM part's maximum SM
  clock) instead of read from the card.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the full 700 W.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
EXP2_PER_CLOCK_PER_SM = 16
SMS = 132
MAX_SM_HZ = 1980e6
EXP2_RATE = EXP2_PER_CLOCK_PER_SM * SMS * MAX_SM_HZ

# kernel names as the profiler shows them (substrings of the symbols)
K1_FORWARD = "flash_fwd_kernel"
K2_BACKWARD = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def unet_flops_per_eval(batch: int, unet: dict, latent: int = 32) -> float:
    """Matmul and conv FLOPs of one UNet eval of ``batch`` samples (2 M N K
    per matmul, 2 HW Cin Cout k^2 per conv; elementwise work and norms
    left out), one cross-attention context token of ``context_dim``.

    :param unet: the config's UNet widths (``model_channels``,
        ``channel_mult``, ``num_res_blocks``, ``attention_resolutions``,
        ``context_dim``, ``in_channels``, ``out_channels``)
    """
    B, L, ch = batch, latent, unet["model_channels"]
    mults = tuple(unet["channel_mult"])
    n_res = unet["num_res_blocks"]
    attn_ds = tuple(unet["attention_resolutions"])
    ctx_dim = unet["context_dim"]
    emb = 4 * ch
    f = 0.0

    def conv(cin, cout, hw, k=3):
        return 2.0 * B * hw * hw * cin * cout * k * k

    def dense(cin, cout, tokens):
        return 2.0 * B * tokens * cin * cout

    def transformer(c, hw):
        tokens = hw * hw
        t = 2 * conv(c, c, hw, k=1)                   # proj in / out
        t += 4 * dense(c, c, tokens)                  # self-attention q, k, v, out
        t += 4.0 * B * tokens * tokens * c            # scores and values
        t += 2 * dense(c, c, tokens)                  # cross-attention q and out
        t += 2 * 2.0 * B * 1 * ctx_dim * c           # cross k, v of one token
        t += 4.0 * B * tokens * 1 * c                 # cross scores and values
        t += dense(c, 8 * c, tokens) + dense(4 * c, c, tokens)  # GEGLU
        return t

    f += conv(unet["in_channels"], ch, L)
    skips = [ch]
    hw, c_prev, ds = L, ch, 1
    for i, m in enumerate(mults):
        c = ch * m
        for _ in range(n_res):
            f += conv(c_prev, c, hw) + conv(c, c, hw)
            if c_prev != c:
                f += conv(c_prev, c, hw, k=1)
            f += 2.0 * B * emb * c
            c_prev = c
            if ds in attn_ds:
                f += transformer(c, hw)
            skips.append(c)
        if i != len(mults) - 1:
            hw //= 2
            ds *= 2
            f += conv(c, c, hw)
            skips.append(c)
    f += 2 * (2 * conv(c_prev, c_prev, hw) + 2.0 * B * emb * c_prev)
    f += transformer(c_prev, hw)
    for i, m in reversed(list(enumerate(mults))):
        c = ch * m
        for _ in range(n_res + 1):
            cin = c_prev + skips.pop()
            f += conv(cin, c, hw) + conv(c, c, hw) + conv(cin, c, hw, k=1)
            f += 2.0 * B * emb * c
            c_prev = c
            if ds in attn_ds:
                f += transformer(c, hw)
        if i != 0:
            hw *= 2
            ds //= 2
            f += conv(c, c, hw)
    f += conv(ch, unet["out_channels"], L)
    return f


def self_attention_shapes(unet: dict, latent: int = 32) -> list:
    """(T, H, D) of every multi-token self-attention of one UNet eval, in
    order: ``num_res_blocks`` per attention level on the way down, one in
    the middle, ``num_res_blocks + 1`` per level on the way up."""
    heads, ch = unet["num_heads"], unet["model_channels"]
    out, mid = [], None
    for level, m in enumerate(unet["channel_mult"]):
        ds = 2 ** level
        hw = latent // ds
        c = ch * m
        if ds in tuple(unet["attention_resolutions"]):
            shape = (hw * hw, heads, c // heads)
            out += [shape] * (unet["num_res_blocks"] + unet["num_res_blocks"] + 1)
        mid = (hw * hw, heads, c // heads)
    return out + [mid]


def kernel_bound(flops: float, nbytes: float, n_exp: float) -> tuple:
    """(seconds, bound_by): the least time the card could take for a
    kernel's work, the largest of its tensor-core operations at the bf16
    peak, its bytes (each input read once, each output written once) at the
    HBM rate, and its exp2 evaluations at the exp unit's rate."""
    terms = {
        "operations": flops / PEAK_BF16_FLOPS,
        "bytes": nbytes / PEAK_HBM_BYTES,
        "exp": n_exp / EXP2_RATE,
    }
    by = max(terms, key=terms.get)
    return terms[by], by


def forward_bound(B: int, T: int, H: int, D: int) -> float:
    """Seconds: the forward kernel's bound at T = S (Q K^T and P V; reads
    Q, K, V and writes O in bf16, the logsumexp in f32; one exp2 per
    score)."""
    flops = 4.0 * B * H * T * T * D
    nbytes = 4.0 * B * T * H * D * 2 + B * H * T * 4
    return kernel_bound(flops, nbytes, B * H * T * T)[0]


def backward_bounds(B: int, T: int, H: int, D: int) -> dict:
    """{"dq", "dkv", "backward"}: (flops, bytes, seconds) of each kernel
    and of the whole backward at T = S.  dq reads q, k, v, O, dO, lse and
    writes dQ and Dsum in 3 products; dkv reads q, k, v, dO, lse, Dsum and
    writes dK, dV in 4; the whole backward reads q, k, v, O, dO, lse and
    writes dQ, dK, dV in the 5 products it needs at least.  One exp2 per
    score in each."""
    n = B * T * H * D * 2
    row = B * H * T * 4
    scores = B * H * T * T
    out = {}
    for key, products, nbytes in (("dq", 3, 6 * n + 2 * row), ("dkv", 4, 6 * n + 2 * row),
                                  ("backward", 5, 8 * n + row)):
        flops = 2.0 * products * scores * D
        out[key] = (flops, nbytes, kernel_bound(flops, nbytes, scores)[0])
    return out
