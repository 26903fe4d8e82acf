"""Streaming graph subsystem: incremental sketch maintenance + serving.

The batch engine (``repro_torch.engine``) answers many queries over one
frozen graph; this package makes the graph itself mutable without giving up
the sketches. Bloom inserts are monotone ORs and MinHash/KMV inserts are
min-merges, so edge deltas are absorbed incrementally (bit-identical to a
from-scratch rebuild); deletions mark rows dirty and are repaired by
selective rebuild under an error-budget policy driven by the paper's own
accuracy bounds. No layer holds a padded ``[n, cap]`` adjacency: the host
keeps sorted edge keys, the device a CSR (see ``dynamic_graph``).

    from repro_torch.stream import stream_session, BatchedQueryServer
    st = stream_session(graph, "bf", storage_budget=0.25)  # graph's device
    st.apply_delta(inserts=new_edges, deletes=gone_edges)
    server = BatchedQueryServer(st)
    rid = server.submit_similarity(pairs, "jaccard")
    answer = server.flush()[rid]          # .value, .latency_s, .staleness
"""
from .cache import CacheEntry, ResultCache
from .dynamic_graph import (DeltaResult, DeviceGraphState, DynamicGraph,
                            HostGraphSnapshot, TrafficMeter)
from .maintenance import STRICT_POLICY, ErrorBudgetPolicy, SketchMaintainer
from .server import BatchedQueryServer, OverloadError, QueryResult
from .session import ServingView, StreamSession, stream_session

__all__ = [
    "CacheEntry", "ResultCache",
    "DeltaResult", "DeviceGraphState", "DynamicGraph", "HostGraphSnapshot",
    "TrafficMeter",
    "ErrorBudgetPolicy", "SketchMaintainer", "STRICT_POLICY",
    "BatchedQueryServer", "OverloadError", "QueryResult",
    "ServingView", "StreamSession", "stream_session",
]
