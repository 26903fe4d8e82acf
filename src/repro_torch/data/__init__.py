"""Data for the port: MinHash near-duplicate dedup (ProbGraph's sketches on
documents) and the synthetic LM batches that training reads."""
from .dedup import document_sketches, jaccard_estimate, k_for, minhash_dedup
from .pipeline import SyntheticLMData, TokenBatcher

__all__ = ["SyntheticLMData", "TokenBatcher", "document_sketches",
           "jaccard_estimate", "k_for", "minhash_dedup"]
