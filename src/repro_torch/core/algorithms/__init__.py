from repro_torch.core.algorithms.pagerank import pagerank
from repro_torch.core.algorithms.connected_components import connected_components
from repro_torch.core.algorithms.traversal import bfs_distances, sssp, reachable_count
