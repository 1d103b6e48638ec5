"""Core layers of the port: threefry, lda, estep, oem, evaluation,
serving, graph, gossip, comm, deleda and the scenario layer."""

from repro_torch.core.scenario import (CompiledScenario, GraphSequence,
                                       Scenario, paper_scenario)

__all__ = ["CompiledScenario", "GraphSequence", "Scenario",
           "paper_scenario"]
