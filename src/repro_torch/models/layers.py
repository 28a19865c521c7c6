"""Shared transformer layers: norms, RoPE, GQA attention (full / sliding-
window / decode with a ring-buffer cache), SwiGLU MLP.

The port of the JAX package's ``models/layers.py``.  Attention has three
paths (:func:`attention_route` picks one from the device and the query
length):
  * on the card, at every query length, the flash-attention kernel
    (:func:`repro_torch.kernels.ops.attention`; under grad its backward
    kernel too), which keeps the S×S scores out of memory in tiles;
  * on the CPU above :data:`CHUNKED_ATTN_THRESHOLD` query tokens, the
    softmax over query chunks (memory O(chunk·S) instead of O(S²)), the
    plain version of the JAX package's own chunked path;
  * otherwise, on the CPU, the plain grouped einsum :func:`_sdpa`.

All functions are pure except that a decode step writes its key and value
into the cache it is given (in place, where the JAX package returns an
updated copy) and returns that cache.  Parameters arrive as dicts built
from the templates in :mod:`repro_torch.models.transformer`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.ref import NEG_INF, attention_mask
from ..sharding import rules
from .params import ParamMeta

# On the CPU, chunked attention kicks in above this query length (keeps
# the S×S score matrix out of the memory footprint).
CHUNKED_ATTN_THRESHOLD = 2048
ATTN_CHUNK = 512

# logical axis names, kept on the templates as the JAX package has them
BATCH, CACHE_SEQ = "batch", "cache_seq"
FSDP, TENSOR, VOCAB, EXPERT = "fsdp", "tensor", "vocab", "expert"


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


def norm_template(cfg) -> Dict[str, ParamMeta]:
    t = {"scale": ParamMeta((cfg.d_model,), (None,), "ones")}
    if cfg.norm == "ln":
        t["bias"] = ParamMeta((cfg.d_model,), (None,), "zeros")
    return t


def apply_norm(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg
               ) -> torch.Tensor:
    if cfg.norm == "ln":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# RoPE (with partial-dim "2d" variant: rotary over a fraction of head_dim)
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         fraction: float) -> torch.Tensor:
    """x (..., S, H, D); positions (S,) int absolute positions."""
    D = x.shape[-1]
    rot = int(D * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    half = rot // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq                # (S, half)
    cos = torch.cos(ang)[..., None, :]                       # (S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:rot]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    return torch.cat([xr1, xr2, x[..., rot:]], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention_template(cfg, d_in: Optional[int] = None) -> Dict[str, Any]:
    d = d_in if d_in is not None else cfg.d_model
    hq, hkv = rules.padded_heads(cfg.num_heads, cfg.num_kv_heads)
    hd = cfg.head_dim_
    kv_ax = TENSOR if hkv % rules.MODEL_AXIS_SIZE == 0 else None
    return {
        "norm": norm_template(cfg),
        "wq": ParamMeta((d, hq, hd), (FSDP, TENSOR, None)),
        "wk": ParamMeta((d, hkv, hd), (FSDP, kv_ax, None)),
        "wv": ParamMeta((d, hkv, hd), (FSDP, kv_ax, None)),
        "wo": ParamMeta((hq, hd, cfg.d_model), (TENSOR, None, FSDP)),
    }


def _sdpa(q, k, v, *, causal: bool, window: Optional[int],
          q_offset: int) -> torch.Tensor:
    """GQA attention, f32 math, returns q.dtype, in the grouped layout (no
    repeated K/V).  ``q_offset``: absolute position of q[0].  (The JAX
    package's flat repeated-KV layout is a sharding choice with the same
    numbers; on one device the grouped one serves.)"""
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = H // Hkv
    m = attention_mask(Sq, Skv, q_offset, causal, window, q.device)
    qg = (q.float() * D ** -0.5).reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    s = s.masked_fill(~m, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def _chunked_attention(q, k, v, *, causal: bool, window: Optional[int],
                       chunk: int = ATTN_CHUNK) -> torch.Tensor:
    """Online attention over query chunks: memory O(chunk·Skv) a step
    instead of O(Sq·Skv)."""
    Sq, Skv = q.shape[1], k.shape[1]
    off = Skv - Sq
    outs = [_sdpa(q[:, i:i + chunk], k, v, causal=causal, window=window,
                  q_offset=i + off) for i in range(0, Sq, chunk)]
    return torch.cat(outs, dim=1)


def attention_route(device_type: str, num_queries: int) -> str:
    """The path :func:`attend` takes: ``"flash"`` (the kernel) on the
    card whatever the query length, else ``"chunked"`` above
    :data:`CHUNKED_ATTN_THRESHOLD` queries and ``"plain"`` up to it."""
    if device_type == "cuda":
        return "flash"
    return "chunked" if num_queries > CHUNKED_ATTN_THRESHOLD else "plain"


def attend(q, k, v, *, causal: bool, window: Optional[int]) -> torch.Tensor:
    route = attention_route(q.device.type, q.shape[1])
    if route == "flash":
        return ops.attention(q, k, v, causal=causal, window=window)
    if route == "chunked":
        return _chunked_attention(q, k, v, causal=causal, window=window)
    return _sdpa(q, k, v, causal=causal, window=window,
                 q_offset=k.shape[1] - q.shape[1])


def _decode_attend(q, ck, cv, kpos, pos, window: Optional[int]
                   ) -> torch.Tensor:
    """Single-token attention against a (ring-buffer) cache.

    q (B,1,H,D); ck/cv (B,Sc,Hkv,D); kpos (Sc,) absolute position of each
    cache slot (−1 = empty); pos () current absolute position."""
    B, _, H, D = q.shape
    _, Sc, Hkv, _ = ck.shape
    G = H // Hkv
    qg = (q.float() * D ** -0.5).reshape(B, 1, Hkv, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, ck.float())
    valid = (kpos >= 0) & (kpos <= pos)
    if window is not None:
        valid &= (pos - kpos) < window
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    o = torch.einsum("bkgqs,bskd->bqkgd", p, cv.float())
    return o.reshape(B, 1, H, D).to(q.dtype)


def attention_apply(p: Dict[str, Any], x: torch.Tensor, cfg, *,
                    positions: torch.Tensor,
                    cache: Optional[Dict[str, torch.Tensor]] = None,
                    kpos: Optional[torch.Tensor] = None,
                    slot: Optional[int] = None,
                    causal: bool = True,
                    window: Optional[int] = None,
                    ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Pre-norm GQA attention block (residual included).

    Train/prefill: ``cache=None`` → full self-attention over ``x``.
    Prefill-with-cache: pass a cache dict → it is filled and returned.
    Decode: ``x`` is (B,1,d); ``cache`` holds keys/values, ``kpos`` their
    absolute positions, ``slot`` the ring-buffer index to write; the key
    and value are written into ``cache`` in place and it is returned.
    """
    h = apply_norm(p["norm"], x, cfg)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(h.dtype))
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"].to(h.dtype))
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"].to(h.dtype))
    q = rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_fraction)

    new_cache = None
    if cache is None:
        out = attend(q, k, v, causal=causal, window=window)
    elif x.shape[1] == 1:                                   # decode step
        ck, cv = cache["k"], cache["v"]
        ck[:, slot] = k[:, 0]
        cv[:, slot] = v[:, 0]
        out = _decode_attend(q, ck, cv, kpos, positions[0], window)
        new_cache = cache
    else:                                                   # prefill, fill cache
        out = attend(q, k, v, causal=causal, window=window)
        Sc = cache["k"].shape[1]
        S = k.shape[1]
        if Sc >= S:
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
        else:
            # ring buffer keeps the tail, rolled so slot j holds the key
            # of absolute position p ≡ j (mod Sc) — the same invariant
            # decode writes with (slot = pos % Sc).
            shift = (S - Sc) % Sc
            cache["k"][:] = torch.roll(k[:, S - Sc:], shift, dims=1)
            cache["v"][:] = torch.roll(v[:, S - Sc:], shift, dims=1)
        new_cache = cache
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(out.dtype))
    return x + y, new_cache


def attention_cache_template(cfg, batch: int, cache_len: int):
    hq, hkv = rules.padded_heads(cfg.num_heads, cfg.num_kv_heads)
    hd = cfg.head_dim_
    kv_ax = TENSOR if hkv % rules.MODEL_AXIS_SIZE == 0 else None
    seq_ax = CACHE_SEQ if kv_ax is None else None
    return {
        "k": ParamMeta((batch, cache_len, hkv, hd),
                       (BATCH, seq_ax, kv_ax, None), "zeros"),
        "v": ParamMeta((batch, cache_len, hkv, hd),
                       (BATCH, seq_ax, kv_ax, None), "zeros"),
    }


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def mlp_template(cfg, d_ff: Optional[int] = None) -> Dict[str, Any]:
    f = d_ff if d_ff is not None else cfg.d_ff
    d = cfg.d_model
    return {
        "norm": norm_template(cfg),
        "wg": ParamMeta((d, f), (FSDP, TENSOR)),
        "wu": ParamMeta((d, f), (FSDP, TENSOR)),
        "wd": ParamMeta((f, d), (TENSOR, FSDP)),
    }


def mlp_apply(p: Dict[str, Any], x: torch.Tensor, cfg) -> torch.Tensor:
    h = apply_norm(p["norm"], x, cfg)
    g = h @ p["wg"].to(h.dtype)
    u = h @ p["wu"].to(h.dtype)
    y = (F.silu(g) * u) @ p["wd"].to(h.dtype)
    return x + y
