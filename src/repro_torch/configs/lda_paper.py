"""The paper's own experimental configuration (DELEDA, §4).

n=50 nodes; complete graph (1225 edges) and Watts-Strogatz (100 edges,
p=0.3); 20 docs/node, V=100, K=5, doc length ~ Poisson(10); centralized
G-OEM baseline with batch 20.
"""

import dataclasses

from repro_torch.core.lda import LDAConfig
from repro_torch.data.lda_synthetic import CorpusSpec


@dataclasses.dataclass(frozen=True)
class PaperSetup:
    lda: LDAConfig = LDAConfig(n_topics=5, vocab_size=100, alpha=0.5,
                               doc_len_max=32, n_gibbs=30, n_gibbs_burnin=15)
    corpus: CorpusSpec = CorpusSpec(n_nodes=50, docs_per_node=20, n_test=100,
                                    doc_len_poisson=10.0)
    ws_k: int = 4                # Watts-Strogatz lattice degree (100 edges)
    ws_p: float = 0.3
    batch_size: int = 20


CONFIG = PaperSetup()
