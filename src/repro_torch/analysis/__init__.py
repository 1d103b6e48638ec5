"""Analysis layer of the port: machine-checked invariants.

The torch counterpart of ``repro.analysis``. Each reference pass and
the port module that stands in for it:

- ``repro.analysis.hlo`` (collectives parsed from post-partitioning HLO)
  -> :mod:`repro_torch.analysis.collectives`: a recorder of what the port
  actually hands to ``torch.distributed``, under the reference's HLO kind
  names.
- ``repro.analysis.trace_audit`` (specs audited against compiled
  modules, ``memory_analysis()`` temp budgets, the jit cache-size
  counter) -> :mod:`repro_torch.analysis.trace_audit`: the same specs,
  rules and registry rows audited against the recorded calls of each
  entry point run at the reference's audit sizes; temp bytes from the
  caching allocator's peak on the card, from a dispatch-mode storage
  meter on the CPU; a compile counter over kernel library loads and
  ``nvcc`` runs; the inventories held against the reference's golden.
- ``repro.analysis.prng_lint`` (a jaxpr key-flow walk) ->
  :mod:`repro_torch.analysis.prng_check`: a run-time tracer over the
  threefry replica, plus a chunk-invariance check for the streams drawn
  inside kernels.
- ``repro.analysis.source_lint`` / ``lint`` ->
  :mod:`repro_torch.analysis.source_lint` / :mod:`.lint`: the four AST
  rules for the port's tree (a ``synchronize()`` is a barrier; ``jax``
  and ``repro`` may not be imported at module level in the port).
- ``repro.analysis.audit`` -> :mod:`repro_torch.analysis.audit`.

The HLO text walk, the jaxpr walk and XLA's ``memory_analysis`` have no
torch counterpart: an eager program has no compiled module to read, so
each check runs the entry point and watches what it does.
"""

from __future__ import annotations
