"""Parallelism for the port: the mesh and its rule tables, the SPMD plan
that places the collectives, ring and Ulysses sequence parallelism, the
plain attention, pipeline schedules over the ``pipe`` axis (GPipe,
circular, 1F1B) and the Mixture-of-Experts FFN with its experts over the
``expert`` axis; the rank-replicated serving loop of tensor-parallel
serving (lockstep.py) and a mesh's ranks replayed in one process
(tp_replay.py, collectives.ReplayWorld)."""

from .mesh import (
    AXIS_ORDER,
    MeshSpec,
    build_hybrid_mesh,
    build_mesh,
    detect_num_slices,
    mesh_from_string,
    parse_mesh,
    single_device_mesh,
    slice_topology,
)
from .sharding import (
    DP_RULES,
    EP_RULES,
    FSDP_RULES,
    FSDP_TP_RULES,
    SP_RULES,
    TP_DECODE_RULES,
    TP_RULES,
    batch_sharding,
    block_placer,
    logical_to_spec,
    merge_rules,
    replicated,
    shard_params,
    sharding_for,
    tree_shardings,
)
from .ring_attention import (
    NEG_INF,
    make_ring_attention,
    reference_attention,
    ring_attention,
    ring_flash_attention,
)
from .ulysses import make_ulysses_attention, ulysses_attention
from .pipeline import (
    make_pipeline, make_pipeline_1f1b, make_pipeline_circular,
    make_pipeline_stacked, stack_stage_params,
)
from .expert import load_balancing_loss, moe_ffn, top_k_routing

__all__ = [
    "AXIS_ORDER", "MeshSpec", "build_hybrid_mesh", "build_mesh",
    "detect_num_slices", "mesh_from_string", "parse_mesh",
    "single_device_mesh", "slice_topology",
    "DP_RULES", "FSDP_RULES", "TP_RULES", "TP_DECODE_RULES", "FSDP_TP_RULES",
    "SP_RULES", "EP_RULES",
    "merge_rules", "logical_to_spec", "sharding_for", "tree_shardings",
    "block_placer", "shard_params", "replicated", "batch_sharding",
    "NEG_INF", "make_ring_attention", "reference_attention", "ring_attention",
    "ring_flash_attention",
    "make_ulysses_attention", "ulysses_attention",
    "make_pipeline", "make_pipeline_1f1b", "make_pipeline_circular",
    "make_pipeline_stacked", "stack_stage_params",
    "moe_ffn", "top_k_routing", "load_balancing_loss",
]
