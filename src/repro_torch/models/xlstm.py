"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

The port's copy of the JAX package's ``models/xlstm.py`` (Beck et al.
2024, arXiv:2405.04517). Both blocks use exponential gating with the
max-stabiliser.

mLSTM, a matrix memory C in R^{dh x dh} per head:
    C_t = f_t C_{t-1} + i_t k_t v_t^T,   n_t = f_t n_{t-1} + i_t k_t
    h_t = C_t^T q_t / max(|n_t . q_t|, exp(-m_t))
in three forms: the parallel one (the decay matrix over the whole
sequence), the chunked one (``_mlstm_chunked``: the quadratic form inside
a chunk, a Python loop carrying (C, n, m) across chunks, the reference's
``lax.scan``), and the one-step recurrence of decode.

sLSTM, a scalar memory per hidden unit with head-wise recurrent mixing
(block-diagonal R_z/R_i/R_f/R_o): a loop over time. No Pallas kernel is
on this path: the products are ``torch`` ops.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import trunc_normal

__all__ = ["LOG_EPS", "XLSTMDims", "MLSTMCache", "init_mlstm_cache",
           "init_mlstm", "mlstm_axes", "apply_mlstm", "SLSTMCache",
           "init_slstm_cache", "init_slstm", "slstm_axes", "apply_slstm"]

LOG_EPS = -30.0


@dataclasses.dataclass(frozen=True)
class XLSTMDims:
    d_model: int
    n_heads: int = 4
    expand_m: int = 2          # mLSTM up-projection factor
    conv_kernel: int = 4
    chunk: int = 0             # 0 = full quadratic parallel form
    ff_factor: float = 4.0 / 3.0  # sLSTM post-FFN

    @property
    def d_inner_m(self) -> int:
        return self.expand_m * self.d_model

    @property
    def dh_m(self) -> int:
        return self.d_inner_m // self.n_heads

    @property
    def dh_s(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_ff_s(self) -> int:
        return int(self.ff_factor * self.d_model)


def _promoted(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype (a bf16 activation times a float32
    weight gives float32, as the reference's einsum does)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


# ----------------------------------------------------------------------------
# mLSTM
# ----------------------------------------------------------------------------

class MLSTMCache(NamedTuple):
    c: torch.Tensor      # [B, H, dh, dh] matrix memory
    n: torch.Tensor      # [B, H, dh]
    m: torch.Tensor      # [B, H] stabiliser
    conv: torch.Tensor   # [B, k-1, d_inner] trailing conv window


def init_mlstm_cache(dims: XLSTMDims, batch: int, dtype,
                     device) -> MLSTMCache:
    h, dh = dims.n_heads, dims.dh_m
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMCache(
        c=torch.zeros((batch, h, dh, dh), **f32),
        n=torch.zeros((batch, h, dh), **f32),
        m=torch.full((batch, h), LOG_EPS, **f32),
        conv=torch.zeros((batch, dims.conv_kernel - 1, dims.d_inner_m),
                         dtype=dtype, device=device))


def init_mlstm(gen: torch.Generator, dims: XLSTMDims, dtype) -> dict:
    d, di, h, dev = dims.d_model, dims.d_inner_m, dims.n_heads, gen.device
    return {
        "w_up": trunc_normal(gen, (d, 2 * di), dtype, fan_in=d),
        "conv_w": trunc_normal(gen, (dims.conv_kernel, di), dtype,
                               fan_in=dims.conv_kernel),
        "conv_b": torch.zeros(di, dtype=dtype, device=dev),
        "wq": trunc_normal(gen, (di, di), dtype, fan_in=di),
        "wk": trunc_normal(gen, (di, di), dtype, fan_in=di),
        "wv": trunc_normal(gen, (di, di), dtype, fan_in=di),
        "w_if": trunc_normal(gen, (di, 2 * h), torch.float32, fan_in=di),
        "b_if": torch.cat([torch.zeros(h, device=dev),
                           torch.linspace(3.0, 6.0, h, device=dev)]),
        "norm_scale": torch.zeros(di, dtype=dtype, device=dev),
        "w_down": trunc_normal(gen, (di, d), dtype, fan_in=di),
    }


def mlstm_axes() -> dict:
    return {"w_up": ("embed", "mlp"), "conv_w": ("conv", "mlp"),
            "conv_b": ("mlp",), "wq": ("mlp", "mlp2"),
            "wk": ("mlp", "mlp2"), "wv": ("mlp", "mlp2"),
            "w_if": ("mlp", "heads"), "b_if": ("heads",),
            "norm_scale": ("mlp",), "w_down": ("mlp", "embed")}


def _headwise_rmsnorm(x: torch.Tensor, scale: torch.Tensor, n_heads: int,
                      eps: float = 1e-6) -> torch.Tensor:
    """RMS-normalise each head's slice on its own. x [..., di]."""
    shp = x.shape
    xh = x.reshape(*shp[:-1], n_heads, shp[-1] // n_heads).float()
    xh = xh * torch.rsqrt((xh * xh).mean(-1, keepdim=True) + eps)
    return (xh.reshape(shp) * (1.0 + scale.float())).to(x.dtype)


def _causal(c: int, device) -> torch.Tensor:
    return torch.tril(torch.ones((c, c), dtype=torch.bool, device=device))


def _mlstm_parallel(q, k, v, log_i, log_f):
    """q,k,v [B,L,H,dh]; log_i/log_f [B,L,H]. Returns (h [B,L,H,dh], m)."""
    dh = q.shape[-1]
    lcum = torch.cumsum(log_f, 1)                             # [B,L,H]
    dmat = (lcum[:, :, None, :] - lcum[:, None, :, :]
            + log_i[:, None, :, :])                           # [B,Lq,Ls,H]
    causal = _causal(dmat.shape[1], q.device)
    dmat = dmat.masked_fill(~causal[None, :, :, None], -torch.inf)
    m = torch.clamp(dmat.amax(2), min=LOG_EPS)                # [B,Lq,H]
    smat = torch.einsum("blhd,bshd->blsh", q, k) * dh ** -0.5
    smat = smat * torch.exp(dmat - m[:, :, None, :])
    denom = torch.maximum(smat.sum(2).abs(), torch.exp(-m))   # [B,L,H]
    return torch.einsum("blsh,bshd->blhd", smat, v) / denom[..., None], m


def _mlstm_chunked(q, k, v, log_i, log_f, chunk: int):
    """Chunkwise-parallel mLSTM: O(L c) instead of O(L^2).

    Inside a chunk the quadratic stabilised form; a loop over the chunks
    carries the (C, n, m) matrix-memory state. q,k,v [B,L,H,dh];
    log_i/log_f [B,L,H]. Returns h [B,L,H,dh].
    """
    bsz, l, h, dh = q.shape
    assert l % chunk == 0, (l, chunk)
    f32 = dict(dtype=torch.float32, device=q.device)
    c_st = torch.zeros((bsz, h, dh, dh), **f32)
    n_st = torch.zeros((bsz, h, dh), **f32)
    m_st = torch.full((bsz, h), LOG_EPS, **f32)
    causal = _causal(chunk, q.device)[None, :, :, None]
    outs = []
    for c0 in range(0, l, chunk):
        qq, kk, vv = (x[:, c0:c0 + chunk] for x in (q, k, v))
        li, lf = log_i[:, c0:c0 + chunk], log_f[:, c0:c0 + chunk]
        lcum = torch.cumsum(lf, 1)                            # [B,c,H]

        # local max over intra-chunk sources
        dmat = (lcum[:, :, None, :] - lcum[:, None, :, :]
                + li[:, None, :, :])                          # [B,t,s,H]
        dmat = dmat.masked_fill(~causal, -torch.inf)
        m_loc = dmat.amax(2)                                  # [B,c,H]
        m_inter = m_st[:, None, :] + lcum                     # [B,c,H]
        m_t = torch.clamp(torch.maximum(m_loc, m_inter), min=LOG_EPS)

        smat = torch.einsum("bthd,bshd->btsh", qq, kk) * dh ** -0.5
        smat = smat * torch.exp(dmat - m_t[:, :, None, :])
        num_intra = torch.einsum("btsh,bshd->bthd", smat, vv)
        den_intra = smat.sum(2)                               # [B,c,H]

        inter_scale = torch.exp(m_inter - m_t)                # [B,c,H]
        num_inter = (torch.einsum("bthd,bhde->bthe", qq, c_st)
                     * inter_scale[..., None])
        den_inter = torch.einsum("bthd,bhd->bth", qq, n_st) * inter_scale

        denom = torch.maximum((den_intra + den_inter).abs(),
                              torch.exp(-m_t))
        outs.append((num_intra + num_inter) / denom[..., None])

        # ---- chunk-end state update
        lc_end = lcum[:, -1, :]                               # [B,H]
        src = lc_end[:, None, :] - lcum + li                  # [B,c,H]
        m_new = torch.clamp(torch.maximum(m_st + lc_end, src.amax(1)),
                            min=LOG_EPS)
        src_w = torch.exp(src - m_new[:, None, :])            # [B,c,H]
        k_s = kk * dh ** -0.5
        decay = torch.exp(m_st + lc_end - m_new)              # [B,H]
        c_st = (c_st * decay[..., None, None]
                + torch.einsum("bch,bchd,bche->bhde", src_w, k_s, vv))
        n_st = (n_st * decay[..., None]
                + torch.einsum("bch,bchd->bhd", src_w, k_s))
        m_st = m_new
    return torch.cat(outs, 1)


def _mlstm_step(cache: MLSTMCache, q, k, v, log_i, log_f):
    """Single-token recurrence. q,k,v [B,H,dh]; log_i/f [B,H]."""
    dh = q.shape[-1]
    m_new = torch.clamp(torch.maximum(log_f + cache.m, log_i), min=LOG_EPS)
    f_s = torch.exp(log_f + cache.m - m_new)[..., None]
    i_s = torch.exp(log_i - m_new)[..., None]
    k_s = k * dh ** -0.5
    c = cache.c * f_s[..., None] + i_s[..., None] * (
        k_s[..., :, None] * v[..., None, :])                  # [B,H,dh,dh]
    n = cache.n * f_s + i_s * k_s
    qn = (n * q).sum(-1)
    denom = torch.maximum(qn.abs(), torch.exp(-m_new))
    h = torch.einsum("bhde,bhd->bhe", c, q) / denom[..., None]
    return h, c, n, m_new


def apply_mlstm(p: dict, dims: XLSTMDims, x: torch.Tensor,
                cache: Optional[MLSTMCache] = None
                ) -> tuple[torch.Tensor, Optional[MLSTMCache]]:
    """x [B, L, d] -> (y [B, L, d], cache'). cache => L == 1 decode."""
    bsz, l, _ = x.shape
    h_n, dh, kc = dims.n_heads, dims.dh_m, dims.conv_kernel
    x_in, z = (x @ p["w_up"]).chunk(2, dim=-1)

    if cache is None:
        pad = F.pad(x_in, (0, 0, kc - 1, 0))
        conv = sum(pad[:, i:i + l] * p["conv_w"][i] for i in range(kc))
        xc = F.silu(conv + p["conv_b"])
        new_conv = None
    else:
        window = torch.cat([cache.conv.to(x_in.dtype), x_in], 1)
        xc = F.silu((window * p["conv_w"]).sum(1) + p["conv_b"])[:, None]
        new_conv = window[:, 1:].to(cache.conv.dtype)

    q = (xc @ p["wq"]).reshape(bsz, l, h_n, dh)
    k = (xc @ p["wk"]).reshape(bsz, l, h_n, dh)
    v = (x_in @ p["wv"]).reshape(bsz, l, h_n, dh)
    gates = xc.float() @ p["w_if"] + p["b_if"]
    log_i, log_f = gates[..., :h_n], F.logsigmoid(gates[..., h_n:])

    if cache is None:
        hq, hk, hv = q.float(), k.float(), v.float()
        if dims.chunk and l > dims.chunk and l % dims.chunk == 0:
            hidden = _mlstm_chunked(hq, hk, hv, log_i, log_f, dims.chunk)
        else:
            hidden, _ = _mlstm_parallel(hq, hk, hv, log_i, log_f)
        new_cache = None
    else:
        hidden, c, n, m = _mlstm_step(
            cache, q[:, 0].float(), k[:, 0].float(), v[:, 0].float(),
            log_i[:, 0], log_f[:, 0])
        hidden = hidden[:, None]
        new_cache = MLSTMCache(c=c, n=n, m=m, conv=new_conv)

    hidden = hidden.reshape(bsz, l, dims.d_inner_m).to(x.dtype)
    hidden = _headwise_rmsnorm(hidden, p["norm_scale"], h_n)
    return (hidden * F.silu(z)) @ p["w_down"], new_cache


# ----------------------------------------------------------------------------
# sLSTM
# ----------------------------------------------------------------------------

class SLSTMCache(NamedTuple):
    c: torch.Tensor   # [B, d] cell
    n: torch.Tensor   # [B, d] normaliser
    h: torch.Tensor   # [B, d] hidden (recurrent input)
    m: torch.Tensor   # [B, d] stabiliser


def init_slstm_cache(dims: XLSTMDims, batch: int, dtype,
                     device) -> SLSTMCache:
    del dtype                                  # the state is float32
    f32 = dict(dtype=torch.float32, device=device)
    d = dims.d_model
    zero = torch.zeros((batch, d), **f32)
    return SLSTMCache(c=zero, n=zero.clone(), h=zero.clone(),
                      m=torch.full((batch, d), LOG_EPS, **f32))


def init_slstm(gen: torch.Generator, dims: XLSTMDims, dtype) -> dict:
    del dtype                                  # the block is float32
    d, h_n, dh, dev = dims.d_model, dims.n_heads, dims.dh_s, gen.device
    f32 = torch.float32
    return {
        "w_gates": trunc_normal(gen, (d, 4 * d), f32, fan_in=d),
        "r_gates": trunc_normal(gen, (h_n, dh, 4 * dh), f32, fan_in=dh),
        "b_gates": torch.cat([torch.zeros(2 * d, device=dev),
                              torch.linspace(3.0, 6.0, d, device=dev),
                              torch.zeros(d, device=dev)]),  # z, i, f, o
        "norm_scale": torch.zeros(d, dtype=f32, device=dev),
        "ff_gate": trunc_normal(gen, (d, dims.d_ff_s), f32, fan_in=d),
        "ff_up": trunc_normal(gen, (d, dims.d_ff_s), f32, fan_in=d),
        "ff_down": trunc_normal(gen, (dims.d_ff_s, d), f32,
                                fan_in=dims.d_ff_s),
    }


def slstm_axes() -> dict:
    return {"w_gates": ("embed", "mlp"), "r_gates": ("heads", "head_dim",
                                                     "state"),
            "b_gates": ("mlp",), "norm_scale": ("embed",),
            "ff_gate": ("embed", "mlp"), "ff_up": ("embed", "mlp"),
            "ff_down": ("mlp", "embed")}


def _slstm_cell(p: dict, dims: XLSTMDims, x_t: torch.Tensor,
                st: SLSTMCache) -> tuple[SLSTMCache, torch.Tensor]:
    """One timestep. x_t [B, d]."""
    d, h_n, dh = dims.d_model, dims.n_heads, dims.dh_s
    b = x_t.shape[0]
    hh = st.h.reshape(b, h_n, dh)
    rec = torch.einsum("bhd,hdg->bhg", hh, p["r_gates"])
    # the reference's reshapes, which keep the [H, 4 dh] order of a row
    rec = rec.reshape(b, 4, h_n, dh).transpose(1, 2)
    rec = rec.reshape(b, h_n, 4, dh).transpose(1, 2).reshape(b, 4 * d)
    pre = x_t.float() @ p["w_gates"] + rec + p["b_gates"]
    zt, it, ft, ot = pre.chunk(4, dim=-1)                  # [B, d] each
    zt = torch.tanh(zt)
    ot = torch.sigmoid(ot)
    log_f = F.logsigmoid(ft)
    m_new = torch.clamp(torch.maximum(log_f + st.m, it), min=LOG_EPS)
    i_s = torch.exp(it - m_new)
    f_s = torch.exp(log_f + st.m - m_new)
    c = f_s * st.c + i_s * zt
    n = torch.clamp(f_s * st.n + i_s, min=1e-6)
    h = ot * (c / n)
    return SLSTMCache(c=c, n=n, h=h, m=m_new), h


def apply_slstm(p: dict, dims: XLSTMDims, x: torch.Tensor,
                cache: Optional[SLSTMCache] = None
                ) -> tuple[torch.Tensor, Optional[SLSTMCache]]:
    """x [B, L, d] -> (y, cache'). A loop over time."""
    bsz, l, d = x.shape
    st = (cache if cache is not None
          else init_slstm_cache(dims, bsz, None, x.device))
    hs = []
    for t in range(l):
        st, h = _slstm_cell(p, dims, x[:, t], st)
        hs.append(h)
    hidden = torch.stack(hs, 1).to(x.dtype)                 # [B, L, d]
    hidden = _headwise_rmsnorm(hidden, p["norm_scale"], dims.n_heads)
    # gated FFN (factor 4/3, GeLU)
    y = _promoted(F.gelu(_promoted(hidden, p["ff_gate"]), approximate="tanh")
                  * _promoted(hidden, p["ff_up"]), p["ff_down"])
    return y.to(x.dtype), (st if cache is not None else None)
