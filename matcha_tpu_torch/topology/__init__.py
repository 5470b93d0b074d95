"""Communication-topology layer: graph zoo, generators, matching
decomposition and spectral utilities.  Port of ``matcha_tpu.topology``:
host-side numpy, copied so that the port imports nothing of the JAX
package."""

from .graphs import (
    DecomposedGraph,
    Edge,
    Matching,
    available_topologies,
    chain_graph,
    complete_graph,
    erdos_renyi_graph,
    graph_size,
    hypercube_graph,
    is_connected,
    make_graph,
    num_nodes,
    random_geometric_graph,
    ring_graph,
    select_graph,
    star_graph,
    torus_graph,
    union_edges,
    validate_decomposition,
    validate_matching,
)
from .decompose import (
    decompose,
    decompose_extract,
    decompose_greedy,
    matchings_to_perms,
    perms_to_neighbors,
)
from .laplacian import (
    algebraic_connectivity,
    base_laplacian,
    edge_laplacian,
    expected_contraction_rate,
    matching_laplacians,
    mixing_matrix,
    spectral_gap_alpha,
)

__all__ = [name for name in dir() if not name.startswith("_")]
