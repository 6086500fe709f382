"""Flash attention for the demo Transformer: Hopper kernels + plain twins.

Port of ``metaopt_tpu/ops/attention.py``'s Pallas route. Three kernels,
written in CUDA C++ for ``sm_90a`` (``csrc/flash_attention.cu``), replace
the three Pallas TPU kernels:

- K1 ``flash_fwd``     ← ``_flash_fwd_kernel``: blocked online-softmax
  attention emitting O and the per-row logsumexp;
- K2 ``flash_bwd_dkv`` ← ``_flash_bwd_dkv_kernel``: dK and dV, one block per
  K tile;
- K3 ``flash_bwd_dq``  ← ``_flash_bwd_dq_kernel``: dQ, one block per Q tile.

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
reference's padded, masked tails. The Pallas route rejects attention
dropout and so does this one (the chunked dropout twin is queued).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

_NEG_BIG = -1e30

#: head dims and dtypes the kernels are instantiated for
SUPPORTED_HEAD_DIMS = (32, 64, 128)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)

#: kernel launches per wrapper since the last :func:`reset_launch_counts`
launches: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# the CUDA library (built at first use, never at import)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "flash_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _L, _P],
    "flash_bwd_dkv": [_P] * 9 + [_I] * 6 + [_L] * 3 + [_P],
    "flash_bwd_dq": [_P] * 8 + [_I] * 6 + [_L] * 3 + [_P],
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


def _launch(name: str, device: torch.device, *args) -> None:
    lib = build()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    launches[name] += 1


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


def flash_fwd_plain(q, k, v, mask=None, block_k: int = 128):
    """Plain PyTorch twin of K1: (out (B,Sq,H,D) in q's dtype, lse (B,H,Sq) f32)."""
    sk = k.shape[1]
    qf, kf, vf = _bh(q), _bh(k), _bh(v)
    b, h, sq, d = qf.shape
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
        acc = alpha * acc + p @ vf[:, :, cols]
        m = m_new
    out = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype).permute(0, 2, 1, 3)
    lse = torch.where(l > 0, m + torch.log(torch.clamp_min(l, 1e-30)),
                      float("inf"))[..., 0]
    return out, lse


def flash_fwd(q, k, v, mask=None, block_k: int = 128):
    """K1: (out, lse). Launches the kernel for CUDA tensors, plain on the CPU."""
    _check(q, k, v, mask)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, mask, block_k)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_fwd: no kernel for device {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    _launch("flash_fwd", q.device, _ptr(q), _ptr(k), _ptr(v), _ptr(mask),
            _ptr(out), _ptr(lse), b, h, sq, k.shape[1], d,
            int(q.dtype == torch.bfloat16), *_mask_strides(mask))
    return out, lse


# ---------------------------------------------------------------------------
# K2, K3: backward


def flash_bwd_dkv_plain(q, k, v, g, lse, delta, mask=None, block_q: int = 128):
    """Plain twin of K2: (dk, dv) in k's/v's dtype, looping over Q blocks."""
    sq = q.shape[1]
    qf, kf, vf, gf = _bh(q), _bh(k), _bh(v), _bh(g)
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
        ds = p * (gb @ vf.transpose(-1, -2) - delta[:, :, rows, None])
        dv = dv + p.transpose(-1, -2) @ gb
        dk = dk + ds.transpose(-1, -2) @ qb
    return (dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def flash_bwd_dq_plain(q, k, v, g, lse, delta, mask=None, block_k: int = 128):
    """Plain twin of K3: dq in q's dtype, looping over K blocks."""
    sk = k.shape[1]
    qf, kf, vf, gf = _bh(q), _bh(k), _bh(v), _bh(g)
    dq = torch.zeros_like(qf)
    for j0 in range(0, sk, block_k):
        cols = slice(j0, j0 + block_k)
        kb, vb = kf[:, :, cols], vf[:, :, cols]
        s = qf @ kb.transpose(-1, -2)
        mb = _mask_bh(mask, slice(None), cols)
        if mb is not None:
            s = torch.where(mb, s, _NEG_BIG)
        p = torch.exp(s - lse[..., None])
        ds = p * (gf @ vb.transpose(-1, -2) - delta[..., None])
        dq = dq + ds @ kb
    return dq.permute(0, 2, 1, 3).to(q.dtype)


def attention_delta(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO ⊙ O) as (B, H, Sq) f32 — computed outside the
    kernels, as the reference computes it in XLA outside its Pallas passes."""
    return (g.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()


def flash_bwd_dkv(q, k, v, g, lse, delta, mask=None, block_q: int = 128):
    """K2: (dk, dv). Launches the kernel for CUDA tensors, plain on the CPU."""
    _check(q, k, v, mask)
    _check_bwd(q, g, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, g, lse, delta, mask, block_q)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_bwd_dkv: no kernel for device {q.device}")
    q, k, v, g = q.contiguous(), k.contiguous(), v.contiguous(), g.contiguous()
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    b, sq, h, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_bwd_dkv", q.device, _ptr(q), _ptr(k), _ptr(v), _ptr(g),
            _ptr(lse), _ptr(delta), _ptr(mask), _ptr(dk), _ptr(dv),
            b, h, sq, k.shape[1], d, int(q.dtype == torch.bfloat16),
            *_mask_strides(mask))
    return dk, dv


def flash_bwd_dq(q, k, v, g, lse, delta, mask=None, block_k: int = 128):
    """K3: dq. Launches the kernel for CUDA tensors, plain on the CPU."""
    _check(q, k, v, mask)
    _check_bwd(q, g, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, g, lse, delta, mask, block_k)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_bwd_dq: no kernel for device {q.device}")
    q, k, v, g = q.contiguous(), k.contiguous(), v.contiguous(), g.contiguous()
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    b, sq, h, d = q.shape
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", q.device, _ptr(q), _ptr(k), _ptr(v), _ptr(g),
            _ptr(lse), _ptr(delta), _ptr(mask), _ptr(dq),
            b, h, sq, k.shape[1], d, int(q.dtype == torch.bfloat16),
            *_mask_strides(mask))
    return dq


# ---------------------------------------------------------------------------
# autograd plumbing (the reference's ``_flash`` custom VJP)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, block_q, block_k):
        out, lse = flash_fwd(q, k, v, mask, block_k)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.blocks = (block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, lse = ctx.saved_tensors
        block_q, block_k = ctx.blocks
        delta = attention_delta(g, out)
        dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, mask, block_q)
        dq = flash_bwd_dq(q, k, v, g, lse, delta, mask, block_k)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    dropout_rate: float = 0.0,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Blocked online-softmax attention with a blockwise two-pass backward.

    q: (B, Sq, H, D), pre-scaled by 1/sqrt(D); k, v: (B, Sk, H, D); mask:
    optional (B, Sq, Sk), True/nonzero = attend, shared by the heads (a
    broadcast view is read through its strides, not copied). Returns (B, Sq,
    H, D) in q's dtype. ``block_q``/``block_k`` set the plain versions'
    blocking (and so their summation order); the CUDA kernels tile with
    their own fixed 64-row tiles.
    """
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout runs in the reference's chunked lax.scan twin, "
            "not in the flash kernels; its port is queued in ROADMAP.md "
            "(Queue 1, 'the chunked dropout twin')"
        )
    if mask is not None and mask.dtype != torch.int8:
        mask = mask.to(torch.int8)
    return _FlashAttention.apply(q, k, v, mask, block_q, block_k)


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
