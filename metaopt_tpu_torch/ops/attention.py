"""Flash attention for the demo Transformer and the LM: Hopper kernels + plain twins.

Port of ``metaopt_tpu/ops/attention.py``'s Pallas route. Three kernels,
written in CUDA C++ for ``sm_90a`` (``csrc/flash_attention.cu``), replace
the three Pallas TPU kernels:

- K1 ``flash_fwd``     ← ``_flash_fwd_kernel`` (:77, launched at :159):
  blocked online-softmax attention emitting O and the per-row logsumexp;
- K2 ``flash_bwd_dkv`` ← ``_flash_bwd_dkv_kernel`` (:181, launched at
  :321): dK and dV, one block per K tile;
- K3 ``flash_bwd_dq``  ← ``_flash_bwd_dq_kernel`` (:238, launched at
  :358): dQ, one block per Q tile.

For bf16 all three run on the tensor cores, with P and dS rounded to bf16
operands in registers: P as one term for dV, P for O and dS as two terms,
head + tail. K1 runs ``mma.sync`` on ``cp.async`` tiles and skips K tiles
that its mask hides from a whole 64-row Q tile. K2 and K3 are built for
the LM's long causal sequences with dropout, where both are bound by bytes
(32.9 and 27.9 µs at B 32 × S 512, H 8, D 64; 3.8 and 3.2 µs at the
slice's S 64; chip_smoke.py computes the bounds): each block first lists
the streamed tiles its mask leaves alive (a causal 512 × 512 mask kills 28
of 64 tile pairs, which are then neither copied, multiplied nor drawn
for), draws one Philox call per four elements and shares its words across
lanes, and runs every product as a ``wgmma`` on 128B-swizzled tiles that
TMA copies into a two-stage ring (tensor maps of the (B, S, H, D) tensors
as they lie, encoded on the host at each launch). For f32 they compute in
f32 on the CUDA cores.

Each wrapper launches its kernel for a CUDA tensor, or raises; for a CPU
tensor it runs the plain PyTorch version beside it (``*_plain``: the same
blockwise math in f32), which is also what the kernels are checked against
on the card. There is no fallback from a CUDA tensor to the plain path.
Each wrapper counts its kernel launches in :data:`launches`.

Layout and semantics follow the reference: q, k, v are (B, S, H, D) with q
pre-scaled; the optional mask is (B, Sq, Sk), True/nonzero = attend,
shared by the heads; lse is (B, H, Sq) f32 with +inf on fully masked rows,
whose output is 0. Ragged lengths need no padding: the kernels and the
plain versions treat rows and columns past Sq/Sk exactly as the
reference's padded, masked tails.

Attention dropout (the reference's chunked ``lax.scan`` twin,
``_chunked_forward`` / ``_chunked_backward`` with ``_dropout_tile``) runs
inside K1–K3: each kernel draws the keep bit of element (b·h, row, column)
in registers with Philox4x32-10, keyed by a 64-bit seed, on the counter
(column / 4, row, b·h, offset), word column % 4, and keeps it when that
word is below (1 − rate)·2³². K1, K2, K3 and :func:`philox_keep` draw the
same bit for the same element, so the backward replays the forward's mask
and no mask is stored. The semantics are the twin's: the softmax
denominator sums the probabilities before dropout, O takes the kept ones
over keep_prob, delta stays rowsum(dO ⊙ O), dV takes the dropped P and
dS = P ⊙ (where(keep, dO·Vᵀ / keep_prob, 0) − delta). The bits are not the
reference's threefry bits: the tests feed the reference's own bits to the
plain versions (``keep=``) and hold the kernels' bits by distribution.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

_NEG_BIG = -1e30

#: head dims and dtypes the kernels are instantiated for
SUPPORTED_HEAD_DIMS = (32, 64, 128)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)

#: kernel launches per wrapper since the last :func:`reset_launch_counts`
launches: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
#: of those, the launches with attention dropout (rate > 0)
dropout_launches: Dict[str, int] = dict(launches)


def reset_launch_counts() -> None:
    for counts in (launches, dropout_launches):
        for name in counts:
            counts[name] = 0


# ---------------------------------------------------------------------------
# Philox4x32-10 keep bits (the kernels' dropout mask)

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo32(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a·b for a constant a < 2³² and int64 b in
    [0, 2³²). a·b can reach 2⁶⁴, past int64, so b is split in 16-bit halves:
    each partial product stays below 2⁴⁸."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    t = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(ctr: Sequence[torch.Tensor], key: Tuple[int, int]) -> Tuple[torch.Tensor, ...]:
    """Random123's Philox4x32-10 on int64 tensors holding uint32 words:
    counter words (c0, c1, c2, c3), key (k0, k1) → four output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_prob(rate: float) -> float:
    """1 − rate as the kernels compute it: in f32, from the rate rounded to f32."""
    return float(1.0 - torch.tensor(rate, dtype=torch.float32))


def keep_threshold(rate: float) -> int:
    """A Philox word w keeps its element when w < this: keep_prob · 2³²."""
    return int(keep_prob(rate) * 4294967296.0)


_Index = Union[range, Sequence[int], torch.Tensor]


def _as_index(x: _Index, device) -> torch.Tensor:
    if isinstance(x, range):
        return torch.arange(x.start, x.stop, x.step, dtype=torch.int64, device=device)
    return torch.as_tensor(x, dtype=torch.int64, device=device).reshape(-1)


def philox_keep(seed: int, offset: int, bh: _Index, rows: _Index, cols: _Index,
                rate: float, device=None) -> torch.Tensor:
    """The kernels' keep bits, (len(bh), len(rows), len(cols)) bool.

    Element (b·h, row, column) is kept when word ``column % 4`` of
    Philox4x32-10 on the counter (column // 4, row, b·h, offset) with the key
    (seed mod 2³², seed // 2³²) is below :func:`keep_threshold` (rate)."""
    _check_dropout(rate, seed, offset)
    bh, rows, cols = (_as_index(x, device) for x in (bh, rows, cols))
    ctr = ((cols >> 2)[None, None, :], rows[None, :, None], bh[:, None, None],
           torch.tensor(offset, dtype=torch.int64, device=cols.device))
    words = torch.stack(torch.broadcast_tensors(
        *philox4x32_10(ctr, (seed & _MASK32, seed >> 32))), -1)
    shape = words.shape[:-1]
    word = words.gather(-1, (cols & 3)[None, None, :, None].expand(*shape, 1))[..., 0]
    return word < keep_threshold(rate)


def draw_seed(generator: torch.Generator) -> Tuple[int, int]:
    """A (seed, offset) pair for the kernels from a CPU generator: no device sync."""
    if generator.device.type != "cpu":
        raise ValueError("attention dropout draws its Philox seed from a CPU "
                         f"torch.Generator (got one on {generator.device})")
    lo, hi, offset = torch.randint(0, 2 ** 32, (3,), generator=generator).tolist()
    return lo | hi << 32, offset


# ---------------------------------------------------------------------------
# the CUDA library (built at first use, never at import)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_U = ctypes.c_ulonglong
_DROPOUT = [_F, _U, _U]  # rate, seed, offset
_SIGNATURES = {
    "flash_fwd": [_P] * 6 + [_I] * 6 + [_L] * 3 + _DROPOUT + [_P],
    "flash_bwd_dkv": [_P] * 9 + [_I] * 6 + [_L] * 3 + _DROPOUT + [_P],
    "flash_bwd_dq": [_P] * 8 + [_I] * 6 + [_L] * 3 + _DROPOUT + [_P],
    # K2's and K3's host cost: ns to encode one launch's four TMA tensor maps
    "flash_tensor_map_ns": [_P] + [_I] * 5,
}


@functools.cache
def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernels' library."""
    from metaopt_tpu_torch.utils import cuda_build

    lib = cuda_build.load(
        "flash_attention", [cuda_build.CSRC_DIR / "flash_attention.cu"])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _launch(name: str, device: torch.device, dropout: Tuple[float, int, int],
            *args) -> None:
    lib = build()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, *dropout, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    launches[name] += 1
    if dropout[0] > 0.0:
        dropout_launches[name] += 1


def _check_dropout(rate: float, seed: int, offset: int) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} must be in [0, 1)")
    if not 0 <= seed < 2 ** 64 or not 0 <= offset <= _MASK32:
        raise ValueError(f"seed {seed} must fit 64 bits and offset {offset} 32 bits")


def _keep_block(q: torch.Tensor, rate: float, seed: int, offset: int,
                keep: Optional[torch.Tensor], rows: slice, cols: slice, sq: int, sk: int):
    """The (B, H, rows, cols) keep bits of one block: the given ones, or
    Philox's; None without dropout."""
    if rate <= 0.0:
        return None
    if keep is not None:
        return keep[:, :, rows, cols].to(q.device)
    b, _, h, _ = q.shape
    bits = philox_keep(seed, offset, range(b * h), range(sq)[rows], range(sk)[cols], rate,
                       device=q.device)
    return bits.view(b, h, *bits.shape[1:])


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _mask_strides(mask: Optional[torch.Tensor]) -> Tuple[int, int, int]:
    return (0, 0, 0) if mask is None else tuple(mask.stride())


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: Optional[torch.Tensor]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, H, D)")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (kernels exist for "
                         f"{SUPPORTED_HEAD_DIMS})")
    if q.dtype not in SUPPORTED_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtype {q.dtype}/{k.dtype}/{v.dtype} not supported "
                         f"(one of {SUPPORTED_DTYPES} for all of q, k, v)")
    if sq == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    if mask is not None:
        if tuple(mask.shape) != (b, sq, k.shape[1]) or mask.dtype != torch.int8:
            raise ValueError(f"mask must be int8 (B, Sq, Sk), got "
                             f"{mask.dtype} {tuple(mask.shape)}")
        if mask.device != q.device:
            raise ValueError("mask is on another device than q")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


def _check_bwd(q: torch.Tensor, g: torch.Tensor, lse: torch.Tensor,
               delta: torch.Tensor) -> None:
    b, sq, h, _ = q.shape
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"dO must match q: got {g.dtype} {tuple(g.shape)} on {g.device}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, h, sq) or t.device != q.device:
            raise ValueError(f"{name} must be (B, H, Sq) = {(b, h, sq)} on "
                             f"{q.device}, got {tuple(t.shape)} on {t.device}")


def _bh(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) → (B, H, S, D) in f32."""
    return t.float().permute(0, 2, 1, 3)


def _mask_bh(mask: Optional[torch.Tensor], rows: slice, cols: slice):
    return None if mask is None else (mask[:, rows, cols] != 0)[:, None]


# ---------------------------------------------------------------------------
# K1: forward


def flash_fwd_plain(q, k, v, mask=None, block_k: int = 128, dropout_rate: float = 0.0,
                    seed: int = 0, offset: int = 0, keep: Optional[torch.Tensor] = None):
    """Plain PyTorch twin of K1: (out (B,Sq,H,D) in q's dtype, lse (B,H,Sq) f32).

    With ``dropout_rate`` > 0 the kept probabilities over keep_prob feed O
    and l sums them all; the keep bits are Philox's for (``seed``,
    ``offset``), or ``keep`` (B, H, Sq, Sk) bool where given (the tests
    inject the reference's own bits)."""
    sq, sk = q.shape[1], k.shape[1]
    qf, kf, vf = _bh(q), _bh(k), _bh(v)
    b, h, _, d = qf.shape
    kp = keep_prob(dropout_rate)
    m = torch.full((b, h, sq, 1), -float("inf"), device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for j0 in range(0, sk, block_k):
        cols = slice(j0, j0 + block_k)
        s = qf @ kf[:, :, cols].transpose(-1, -2)
        mb = _mask_bh(mask, slice(None), cols)
        if mb is not None:
            s = torch.where(mb, s, _NEG_BIG)
        # floor the running max above the mask fill: a fully masked block
        # would otherwise get exp(s - m) = 1 (uniform attention)
        m_new = torch.clamp_min(
            torch.maximum(m, s.amax(-1, keepdim=True)), 0.5 * _NEG_BIG)
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        kb = _keep_block(q, dropout_rate, seed, offset, keep, slice(None), cols, sq, sk)
        if kb is not None:
            p = torch.where(kb, p / kp, 0.0)
        acc = alpha * acc + p @ vf[:, :, cols]
        m = m_new
    out = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype).permute(0, 2, 1, 3)
    lse = torch.where(l > 0, m + torch.log(torch.clamp_min(l, 1e-30)),
                      float("inf"))[..., 0]
    return out, lse


def _check_keep(name: str, q: torch.Tensor, keep: Optional[torch.Tensor]) -> None:
    if keep is not None and q.device.type != "cpu":
        raise ValueError(f"{name}: injected keep bits run only in the plain version "
                         f"(CPU tensors); the kernel draws its own from (seed, offset)")


def flash_fwd(q, k, v, mask=None, block_k: int = 128, dropout_rate: float = 0.0,
              seed: int = 0, offset: int = 0, keep: Optional[torch.Tensor] = None):
    """K1: (out, lse). Launches the kernel for CUDA tensors, plain on the CPU
    (where ``keep`` may inject the keep bits, as ``flash_fwd_plain`` takes
    them)."""
    _check(q, k, v, mask)
    _check_dropout(dropout_rate, seed, offset)
    _check_keep("flash_fwd", q, keep)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, mask, block_k, dropout_rate, seed, offset, keep)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_fwd: no kernel for device {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    _launch("flash_fwd", q.device, (dropout_rate, seed, offset),
            _ptr(q), _ptr(k), _ptr(v), _ptr(mask),
            _ptr(out), _ptr(lse), b, h, sq, k.shape[1], d,
            int(q.dtype == torch.bfloat16), *_mask_strides(mask))
    return out, lse


# ---------------------------------------------------------------------------
# K2, K3: backward


def _dropped(p: torch.Tensor, gp: torch.Tensor, kb: Optional[torch.Tensor], kp: float):
    """(P for dV, dO·Vᵀ for dS) under the keep bits ``kb``, as the twin's
    backward drops both."""
    if kb is None:
        return p, gp
    return torch.where(kb, p / kp, 0.0), torch.where(kb, gp / kp, 0.0)


def flash_bwd_dkv_plain(q, k, v, g, lse, delta, mask=None, block_q: int = 128,
                        dropout_rate: float = 0.0, seed: int = 0, offset: int = 0,
                        keep: Optional[torch.Tensor] = None):
    """Plain twin of K2: (dk, dv) in k's/v's dtype, looping over Q blocks."""
    sq, sk = q.shape[1], k.shape[1]
    qf, kf, vf, gf = _bh(q), _bh(k), _bh(v), _bh(g)
    kp = keep_prob(dropout_rate)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for i0 in range(0, sq, block_q):
        rows = slice(i0, i0 + block_q)
        qb, gb = qf[:, :, rows], gf[:, :, rows]
        s = qb @ kf.transpose(-1, -2)
        mb = _mask_bh(mask, rows, slice(None))
        if mb is not None:
            s = torch.where(mb, s, _NEG_BIG)
        # fully masked rows carry lse = +inf from the forward → p = 0
        p = torch.exp(s - lse[:, :, rows, None])
        kb = _keep_block(q, dropout_rate, seed, offset, keep, rows, slice(None), sq, sk)
        pd, gp = _dropped(p, gb @ vf.transpose(-1, -2), kb, kp)
        ds = p * (gp - delta[:, :, rows, None])
        dv = dv + pd.transpose(-1, -2) @ gb
        dk = dk + ds.transpose(-1, -2) @ qb
    return (dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def flash_bwd_dq_plain(q, k, v, g, lse, delta, mask=None, block_k: int = 128,
                       dropout_rate: float = 0.0, seed: int = 0, offset: int = 0,
                       keep: Optional[torch.Tensor] = None):
    """Plain twin of K3: dq in q's dtype, looping over K blocks."""
    sq, sk = q.shape[1], k.shape[1]
    qf, kf, vf, gf = _bh(q), _bh(k), _bh(v), _bh(g)
    kp = keep_prob(dropout_rate)
    dq = torch.zeros_like(qf)
    for j0 in range(0, sk, block_k):
        cols = slice(j0, j0 + block_k)
        kb, vb = kf[:, :, cols], vf[:, :, cols]
        s = qf @ kb.transpose(-1, -2)
        mb = _mask_bh(mask, slice(None), cols)
        if mb is not None:
            s = torch.where(mb, s, _NEG_BIG)
        p = torch.exp(s - lse[..., None])
        keep_b = _keep_block(q, dropout_rate, seed, offset, keep, slice(None), cols, sq, sk)
        _, gp = _dropped(p, gf @ vb.transpose(-1, -2), keep_b, kp)
        ds = p * (gp - delta[..., None])
        dq = dq + ds @ kb
    return dq.permute(0, 2, 1, 3).to(q.dtype)


def attention_delta(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO ⊙ O) as (B, H, Sq) f32 — computed outside the
    kernels, as the reference computes it in XLA outside its Pallas passes."""
    return (g.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()


def flash_bwd_dkv(q, k, v, g, lse, delta, mask=None, block_q: int = 128,
                  dropout_rate: float = 0.0, seed: int = 0, offset: int = 0,
                  keep: Optional[torch.Tensor] = None):
    """K2: (dk, dv). Launches the kernel for CUDA tensors, plain on the CPU."""
    _check(q, k, v, mask)
    _check_bwd(q, g, lse, delta)
    _check_dropout(dropout_rate, seed, offset)
    _check_keep("flash_bwd_dkv", q, keep)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, g, lse, delta, mask, block_q,
                                   dropout_rate, seed, offset, keep)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_bwd_dkv: no kernel for device {q.device}")
    q, k, v, g = q.contiguous(), k.contiguous(), v.contiguous(), g.contiguous()
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    b, sq, h, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_bwd_dkv", q.device, (dropout_rate, seed, offset),
            _ptr(q), _ptr(k), _ptr(v), _ptr(g),
            _ptr(lse), _ptr(delta), _ptr(mask), _ptr(dk), _ptr(dv),
            b, h, sq, k.shape[1], d, int(q.dtype == torch.bfloat16),
            *_mask_strides(mask))
    return dk, dv


def flash_bwd_dq(q, k, v, g, lse, delta, mask=None, block_k: int = 128,
                 dropout_rate: float = 0.0, seed: int = 0, offset: int = 0,
                 keep: Optional[torch.Tensor] = None):
    """K3: dq. Launches the kernel for CUDA tensors, plain on the CPU."""
    _check(q, k, v, mask)
    _check_bwd(q, g, lse, delta)
    _check_dropout(dropout_rate, seed, offset)
    _check_keep("flash_bwd_dq", q, keep)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, g, lse, delta, mask, block_k,
                                  dropout_rate, seed, offset, keep)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_bwd_dq: no kernel for device {q.device}")
    q, k, v, g = q.contiguous(), k.contiguous(), v.contiguous(), g.contiguous()
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    b, sq, h, d = q.shape
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", q.device, (dropout_rate, seed, offset),
            _ptr(q), _ptr(k), _ptr(v), _ptr(g),
            _ptr(lse), _ptr(delta), _ptr(mask), _ptr(dq),
            b, h, sq, k.shape[1], d, int(q.dtype == torch.bfloat16),
            *_mask_strides(mask))
    return dq


# ---------------------------------------------------------------------------
# autograd plumbing (the reference's ``_flash`` custom VJP)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, block_q, block_k, dropout_rate, seed, offset, keep):
        dropout = (dropout_rate, seed, offset)
        out, lse = flash_fwd(q, k, v, mask, block_k, *dropout, keep)
        ctx.save_for_backward(q, k, v, mask, out, lse, keep)
        ctx.blocks = (block_q, block_k)
        ctx.dropout = dropout  # the backward replays the forward's keep bits
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, lse, keep = ctx.saved_tensors
        block_q, block_k = ctx.blocks
        delta = attention_delta(g, out)
        dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, mask, block_q, *ctx.dropout, keep)
        dq = flash_bwd_dq(q, k, v, g, lse, delta, mask, block_k, *ctx.dropout, keep)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    dropout_rate: float = 0.0,
    philox: Optional[Tuple[int, int]] = None,
    keep: Optional[torch.Tensor] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Blocked online-softmax attention with a blockwise two-pass backward.

    q: (B, Sq, H, D), pre-scaled by 1/sqrt(D); k, v: (B, Sk, H, D); mask:
    optional (B, Sq, Sk), True/nonzero = attend, shared by the heads (a
    broadcast view is read through its strides, not copied). Returns (B, Sq,
    H, D) in q's dtype. ``dropout_rate`` > 0 drops attention probabilities
    inside the kernels with the Philox pair ``philox``, drawn by
    :func:`draw_seed` from a CPU ``torch.Generator`` (the draw needs no
    device sync); the backward replays the same bits. On CPU tensors ``keep``, (B, H, Sq, Sk)
    bool, injects the keep bits instead (the tests feed the reference's).
    ``block_q``/``block_k`` set the plain versions' blocking (and so their
    summation order); the CUDA kernels tile with their own fixed 64-row
    tiles.
    """
    seed = offset = 0
    if dropout_rate > 0.0:
        if (philox is None) == (keep is None):
            raise ValueError("dropout_rate > 0 needs one of a philox (seed, offset) pair, "
                             "drawn by draw_seed(generator), or keep bits")
        if philox is not None:
            seed, offset = philox
    if mask is not None and mask.dtype != torch.int8:
        mask = mask.to(torch.int8)
    return _FlashAttention.apply(q, k, v, mask, block_q, block_k, float(dropout_rate),
                                 seed, offset, keep if dropout_rate > 0.0 else None)


def reference_attention(q, k, v, mask=None):
    """Plain O(S²) attention in f32 — the oracle (the reference's
    ``_reference_attention`` without dropout); fully masked rows give 0."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if mask is not None:
        s = torch.where(mask[:, None] != 0, s, _NEG_BIG)
    p = torch.softmax(s, dim=-1)
    if mask is not None:
        p = torch.where((mask != 0).any(-1)[:, None, :, None], p, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# one rank's shard of a mesh


_MIX = 0x9E3779B97F4A7C15
_M64 = (1 << 64) - 1


def shard_philox(philox: Tuple[int, int], coordinate: Sequence[int]) -> Tuple[int, int]:
    """The Philox pair of one mesh coordinate: the seed mixed with each
    coordinate (splitmix64's finalizer), the offset kept. The reference folds
    the mesh coordinates into its key (``jax.random.fold_in``); this keeps
    two ranks from drawing one stream for different heads or rows."""
    seed, offset = philox
    for c in coordinate:
        z = (seed + _MIX * (int(c) + 1)) & _M64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        seed = z ^ (z >> 31)
    return seed, offset


def sharded_flash_attention(mesh, q, k, v, mask=None, *, dropout_rate: float = 0.0,
                            philox: Optional[Tuple[int, int]] = None,
                            keep: Optional[torch.Tensor] = None,
                            batch_axis: str = "dp", head_axis: str = "tp", **kwargs):
    """One rank's (B/dp, S, H/tp, D) slab of attention over the mesh: batch
    on ``dp``, heads on ``tp``, no collective (attention is independent
    over batch and heads), so the Megatron column split of q/k/v stays local
    and K1–K3 run on the slab.

    q, k, v and ``mask`` are this rank's slices; ``keep`` (CPU only) its
    (B/dp, H/tp, Sq, Sk) keep bits. The Philox pair is made distinct per
    (dp, tp) coordinate (:func:`shard_philox`), as the reference folds the
    coordinates into its key."""
    from metaopt_tpu_torch.parallel.mesh import axis_index

    if dropout_rate > 0.0 and philox is not None:
        philox = shard_philox(philox, [axis_index(mesh, batch_axis),
                                       axis_index(mesh, head_axis)])
    return flash_attention(q, k, v, mask, dropout_rate=dropout_rate, philox=philox,
                           keep=keep, **kwargs)
