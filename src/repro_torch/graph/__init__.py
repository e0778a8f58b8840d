"""repro_torch.graph — the GEMM-program IR that traces, fuses and schedules
whole layer pipelines (the port of ``repro.graph``).

- :mod:`repro_torch.graph.ir` — the typed IR: ``GemmNode``,
  ``EpilogueNode``, ``CastNode``, ``GroupNode`` in an SSA ``Graph`` with a
  stable program signature, and :func:`stack_group_weights`.
- :mod:`repro_torch.graph.trace` — capture: the explicit ``GraphBuilder``
  (what the model layers use) and :func:`trace_gemms`, which records every
  GEMM issued through :mod:`repro_torch.kernels.ops`.
- :mod:`repro_torch.graph.fuse` — rewrite rules: epilogue absorption,
  cast elimination, sibling grouping.
- :mod:`repro_torch.graph.schedule` — whole-program scheduling against the
  plan cache with the Hopper model (grouped vs. ungrouped, tile
  stabilization, the prefetch annotation), memoization, execution.

Consumers: ``models/layers.py`` (the MLP block) and ``models/attention.py``
(the q/k/v projections and the grouped decode q/k/v).
``ArchConfig.use_graph`` (default True) gates the compiled path.  Forward
only.  ``merge_graphs`` joins independent programs into one (the serving
engine's speculative step).
"""
from repro_torch.graph.ir import (CastNode, EpilogueNode, GemmNode, Graph,
                                  GroupNode, stack_group_weights)
from repro_torch.graph.trace import GraphBuilder, merge_graphs, trace_gemms
from repro_torch.graph.schedule import (CompiledProgram, compile_cached,
                                        compile_graph)
from repro_torch.graph.fuse import fuse as fuse_graph

__all__ = [
    "CastNode", "EpilogueNode", "GemmNode", "GroupNode", "Graph",
    "GraphBuilder", "CompiledProgram", "compile_graph", "compile_cached",
    "fuse_graph", "merge_graphs", "trace_gemms", "stack_group_weights",
]
