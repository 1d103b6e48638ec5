"""Mamba2 (SSD) block: chunked scan for prefill, recurrence for decode.

The port's copy of the JAX package's ``models/mamba2.py``. State-space
duality form (Dao & Gu 2024): per head h with state size n,

    s_t = exp(dt_t A) s_{t-1} + dt_t x_t B_t^T,     y_t = C_t s_t + D x_t

The full sequence runs the *chunked* algorithm: within a chunk of length
c the quadratic masked-decay form, and a Python loop over the chunks
carries the ``[B, H, P, N]`` state (the reference's ``lax.scan``).
Decode is the one-step recurrence on a carried (conv, ssm) cache, whose
size does not grow with the sequence. Layout as the reference: in_proj
-> (z, x, B, C, dt); a depthwise causal conv over (x, B, C); one group
(B, C shared across heads). No Pallas kernel is on this path: the
products are ``torch`` ops.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import trunc_normal

__all__ = ["Mamba2Dims", "MambaCache", "init_mamba_cache", "mamba_cache_axes",
           "init_mamba2", "mamba2_axes", "apply_mamba2"]


@dataclasses.dataclass(frozen=True)
class Mamba2Dims:
    d_model: int
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.head_dim == 0
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.d_state

    @property
    def d_in_proj(self) -> int:
        return 2 * self.d_inner + 2 * self.d_state + self.n_heads


class MambaCache(NamedTuple):
    conv: torch.Tensor   # [B, conv_kernel-1, conv_dim] trailing inputs
    ssm: torch.Tensor    # [B, n_heads, head_dim, d_state] float32


def init_mamba_cache(dims: Mamba2Dims, batch: int, dtype,
                     device) -> MambaCache:
    return MambaCache(
        conv=torch.zeros((batch, dims.conv_kernel - 1, dims.conv_dim),
                         dtype=dtype, device=device),
        ssm=torch.zeros((batch, dims.n_heads, dims.head_dim, dims.d_state),
                        dtype=torch.float32, device=device))


def mamba_cache_axes() -> MambaCache:
    return MambaCache(conv=("batch", "seq", "mlp"),
                      ssm=("batch", "heads", "head_dim", "state"))


def init_mamba2(gen: torch.Generator, dims: Mamba2Dims, dtype) -> dict:
    h, dev = dims.n_heads, gen.device
    # dt bias ~ softplus^-1 of dt in [1e-3, 1e-1] (mamba init)
    u = torch.empty(h, dtype=torch.float32, device=dev).uniform_(
        generator=gen)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    return {
        "in_proj": trunc_normal(gen, (dims.d_model, dims.d_in_proj), dtype,
                                fan_in=dims.d_model),
        "conv_w": trunc_normal(gen, (dims.conv_kernel, dims.conv_dim),
                               dtype, fan_in=dims.conv_kernel),
        "conv_b": torch.zeros(dims.conv_dim, dtype=dtype, device=dev),
        "A_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                        device=dev)),
        "D": torch.ones(h, dtype=torch.float32, device=dev),
        "dt_bias": dt_bias,
        "norm_scale": torch.zeros(dims.d_inner, dtype=dtype, device=dev),
        "out_proj": trunc_normal(gen, (dims.d_inner, dims.d_model), dtype,
                                 fan_in=dims.d_inner),
    }


def mamba2_axes() -> dict:
    return {
        "in_proj": ("embed", "mlp"),
        "conv_w": ("conv", "mlp"),
        "conv_b": ("mlp",),
        "A_log": ("heads",),
        "D": ("heads",),
        "dt_bias": ("heads",),
        "norm_scale": ("mlp",),
        "out_proj": ("mlp", "embed"),
    }


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    yf = (y * F.silu(z)).float()
    var = (yf * yf).mean(-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps)
            * (1.0 + scale.float())).to(y.dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """[..., c] -> [..., c, c]: S[i,j] = sum_{j<k<=i} x_k, -inf for j>i."""
    c = x.shape[-1]
    cum = torch.cumsum(x, -1)
    s = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    return s.masked_fill(~mask, -math.inf)


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b_in: torch.Tensor, c_in: torch.Tensor, chunk: int,
                 init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x [B,L,H,P]; dt [B,L,H] (post-softplus); a [H] (negative);
    b_in, c_in [B,L,N] (one group). Returns (y [B,L,H,P],
    final_state [B,H,P,N]).
    """
    bsz, l, h, p = x.shape
    n = b_in.shape[-1]
    assert l % chunk == 0, (l, chunk)
    nc = l // chunk

    xd = x * dt[..., None]                                   # dt-weighted x
    da = dt * a[None, None, :]                          # [B,L,H] log-decay

    xd = xd.reshape(bsz, nc, chunk, h, p)
    da = da.reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2)   # [B,H,nc,c]
    bm = b_in.reshape(bsz, nc, chunk, n)
    cm = c_in.reshape(bsz, nc, chunk, n)

    da_cum = torch.cumsum(da, -1)                            # [B,H,nc,c]
    lmat = torch.exp(_segsum(da))                            # [B,H,nc,c,c]

    # intra-chunk (diagonal blocks): bcln,bcsn,bhcls,bcshp->bclhp
    cb = torch.einsum("bcln,bcsn->bcls", cm, bm)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", cb[:, None] * lmat, xd)

    # per-chunk end states: bcln,bhcl,bclhp->bchpn
    decay_states = torch.exp(da_cum[..., -1:] - da_cum)      # [B,H,nc,c]
    states = torch.einsum("bcln,bclhp->bchpn", bm,
                          xd * decay_states.permute(0, 2, 3, 1)[..., None])

    # inter-chunk recurrence (the reference's lax.scan)
    chunk_decay = torch.exp(da_cum[..., -1])                 # [B,H,nc]
    s = (torch.zeros((bsz, h, p, n), dtype=x.dtype, device=x.device)
         if init_state is None else init_state.to(x.dtype))
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, 1)                       # [B,nc,H,P,N]

    # inter-chunk contribution: bcln,bchpn,bhcl->bclhp
    state_decay = torch.exp(da_cum)                          # [B,H,nc,c]
    y_off = (torch.einsum("bcln,bchpn->bclhp", cm, prev_states)
             * state_decay.permute(0, 2, 3, 1)[..., None])

    y = (y_diag + y_off).reshape(bsz, l, h, p)
    return y, s


def apply_mamba2(p: dict, dims: Mamba2Dims, x: torch.Tensor,
                 cache: Optional[MambaCache] = None
                 ) -> tuple[torch.Tensor, Optional[MambaCache]]:
    """x [B, L, d_model] -> (y, new_cache). cache => single-step decode."""
    bsz, l, _ = x.shape
    h, pd, n = dims.n_heads, dims.head_dim, dims.d_state

    zxbcdt = x @ p["in_proj"]
    z, xbc, dt_raw = torch.split(
        zxbcdt, [dims.d_inner, dims.conv_dim, h], dim=-1)

    k = dims.conv_kernel
    if cache is None:
        # causal depthwise conv over the sequence
        pad = F.pad(xbc, (0, 0, k - 1, 0))
        xbc = sum(pad[:, i:i + l] * p["conv_w"][i] for i in range(k))
        xbc = F.silu(xbc + p["conv_b"])
        new_conv = None
    else:
        # decode: l == 1; window = [conv_state, xbc]
        window = torch.cat([cache.conv.to(xbc.dtype), xbc], 1)
        xbc = F.silu((window * p["conv_w"]).sum(1) + p["conv_b"])[:, None]
        new_conv = window[:, 1:].to(cache.conv.dtype)

    xs, b_in, c_in = torch.split(xbc, [dims.d_inner, n, n], dim=-1)
    xs = xs.reshape(bsz, l, h, pd)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])            # [B,L,H]
    a = -torch.exp(p["A_log"])                                # [H] negative

    if cache is None:
        y, _ = _ssd_chunked(xs.float(), dt, a, b_in.float(), c_in.float(),
                            min(dims.chunk, l))
        new_cache = None
    else:
        da = torch.exp(dt[:, 0] * a)                          # [B,H]
        dbx = (xs[:, 0].float()[..., None] * b_in[:, 0].float()[:, None,
                                                                None, :]
               * dt[:, 0, :, None, None])                     # [B,H,P,N]
        s = cache.ssm * da[..., None, None] + dbx
        y = torch.einsum("bn,bhpn->bhp", c_in[:, 0].float(), s)[:, None]
        new_cache = MambaCache(conv=new_conv, ssm=s)

    y = y + xs.float() * p["D"][:, None]
    y = y.reshape(bsz, l, dims.d_inner).to(x.dtype)
    y = _gated_norm(y, z, p["norm_scale"])
    return y @ p["out_proj"], new_cache
