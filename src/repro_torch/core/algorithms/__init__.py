from repro_torch.core.algorithms.pagerank import pagerank
from repro_torch.core.algorithms.connected_components import connected_components
from repro_torch.core.algorithms.two_hop import (
    two_hop_pairs,
    two_hop_count_upper_bound,
    multi_account_pairs,
)
from repro_torch.core.algorithms.degrees import degree_stats
from repro_torch.core.algorithms.similarity import jaccard_similarity, common_neighbors
from repro_torch.core.algorithms.traversal import bfs_distances, sssp, reachable_count
from repro_torch.core.algorithms.community import label_propagation, num_communities
from repro_torch.core.algorithms.triangles import triangle_count, k_core, core_size
