"""Gibbs Online EM (G-OEM) for LDA: the centralized learner.

The torch counterpart of ``repro.core.oem``. The sufficient-statistics
update (paper eq. (2)),

    s^{t+1} = (1 - rho_{t+1}) s^t + rho_{t+1} E[S(X_{t+1}, h_{t+1})],

with the expectation approximated by collapsed Gibbs sweeps (the
``lda_gibbs`` kernel on the card) and the M-step ``eta_star``.
:func:`run_oem` is a Python loop over the reference's key tree, so it
replays the reference's minibatches and E-step streams.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import estep as estep_mod
from repro_torch.core import threefry as tf3
from repro_torch.core.lda import LDAConfig, LDAState, eta_star, init_state

__all__ = ["make_rho_schedule", "make_decay_schedule", "forgetting_rho",
           "oem_update", "OEMTrace", "run_oem"]


def make_rho_schedule(kind: str = "power", *, kappa: float = 0.6,
                      t0: float = 10.0, rho0: float = 1.0,
                      constant: float = 0.05
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """rho(t) for t = 1, 2, ... (a 0-d integer tensor), float32."""
    if kind == "power":
        def rho(t):
            return rho0 * (t0 + t.to(torch.float32)) ** (-kappa)
    elif kind == "constant":
        def rho(t):
            return torch.full((), constant, dtype=torch.float32,
                              device=t.device)
    else:
        raise ValueError(f"unknown rho schedule {kind!r}")
    return rho


def make_decay_schedule(tau0: float, kappa: float
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Robbins-Monro forgetting rate d_t = (tau0 + t)^-kappa."""
    if not 0.0 < kappa <= 1.0:
        raise ValueError(f"decay kappa must be in (0, 1], got {kappa}")
    if tau0 < 0.0:
        raise ValueError(f"decay tau0 must be >= 0, got {tau0}")
    return make_rho_schedule("power", kappa=kappa, t0=tau0)


def forgetting_rho(rho: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """Fold a forgetting rate into the blend weight: 1 - (1-rho)(1-d)."""
    return 1.0 - (1.0 - rho) * (1.0 - decay)


def oem_update(config: LDAConfig, state: LDAState, key: torch.Tensor,
               words: torch.Tensor, mask: torch.Tensor,
               rho_fn: Callable[[torch.Tensor], torch.Tensor],
               estep=None, decay_fn=None) -> LDAState:
    """One G-OEM step on a minibatch (eq. 2)."""
    estep = estep or estep_mod.get_estep()
    t = state.step + 1
    beta = eta_star(state.stats, config.tau)
    result = estep(config, key, words, mask, beta)
    rho = rho_fn(t).to(state.stats.dtype)
    if decay_fn is not None:
        decay = torch.clamp(decay_fn(t), 0.0, 1.0).to(state.stats.dtype)
        rho = forgetting_rho(rho, decay)
    new_stats = (1.0 - rho) * state.stats + rho * result.stats
    return LDAState(stats=new_stats, step=t,
                    stats_version=state.stats_version + 1)


class OEMTrace(NamedTuple):
    state: LDAState
    stats_history: torch.Tensor   # [T_record, K, V] recorded snapshots


def run_oem(config: LDAConfig, key: torch.Tensor, words: torch.Tensor,
            mask: torch.Tensor, n_steps: int, batch_size: int,
            record_every: int = 10, rho_kind: str = "power",
            rho_kappa: float = 0.6, rho_t0: float = 10.0,
            decay: tuple[float, float] | None = None,
            init: LDAState | None = None) -> OEMTrace:
    """Centralized G-OEM for ``n_steps``, ``batch_size`` documents drawn
    uniformly per step from ``words``/``mask`` ``[D, L]`` (paper S4).

    Runs on the device of ``words``. The key tree is the reference's:
    ``(k_init, k_run) = split(key)``, one key per record block, one per
    step, split into the minibatch draw and the E-step stream. ``init``
    starts from a given state instead of ``init_state(config, k_init)``
    (the tests start from the reference's initial statistic).
    """
    if n_steps % record_every != 0:
        raise ValueError("n_steps must be divisible by record_every")
    rho_fn = make_rho_schedule(rho_kind, kappa=rho_kappa, t0=rho_t0)
    decay_fn = make_decay_schedule(*decay) if decay is not None else None
    estep = estep_mod.get_estep()
    key = tf3.key_data(key).to(words.device)
    d = words.shape[0]
    k_init, k_run = tf3.split(key)
    state = init if init is not None else init_state(config, k_init)
    history = []
    for k_block in tf3.split(k_run, n_steps // record_every):
        for k in tf3.split(k_block, record_every):
            k_sel, k_gibbs = tf3.split(k)
            idx = tf3.randint(k_sel, (batch_size,), 0, d)
            state = oem_update(config, state, k_gibbs, words[idx],
                               mask[idx], rho_fn, estep=estep,
                               decay_fn=decay_fn)
        history.append(state.stats)
    return OEMTrace(state=state, stats_history=torch.stack(history))
