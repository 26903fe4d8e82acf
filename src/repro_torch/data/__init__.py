"""Data-side uses of ProbGraph's sketches: MinHash near-duplicate dedup.

Only the dedup names are ported here; the reference's ``pipeline.py``
(synthetic LM batches) belongs to its LLM scaffolding, which no mining path
uses and which is not part of the port yet.
"""
from .dedup import document_sketches, jaccard_estimate, k_for, minhash_dedup

__all__ = ["document_sketches", "jaccard_estimate", "k_for", "minhash_dedup"]
