"""slimm_jax — taxonomic profiling engine on JAX.

A from-scratch JAX/XLA re-design of the capabilities of seqan/slimm
(reference mounted read-only at /root/reference; see SURVEY.md):
BAM/SAM alignments + a taxonomy database → per-contig binned coverage,
coverage-quantile filtering, LCA read reassignment, per-rank abundance TSVs.

Layout:
  taxonomy   ranks, lineage layout, accession parsing
  config     option dataclasses (CLI-default parity)
  database   .sldb (cereal-compatible) + .npz DB, slimm_build pipeline,
             dense-tensor taxonomy
  io         SAM/BAM/FASTA decode → dense record arrays (+ native C++ path)
  state      shared profile state, propagation, report rows
  oracle     scalar reference semantics (golden fixtures / verification)
  engine     the jit device pipeline (single-device + sharded)
  parallel   mesh construction, shard_map data parallelism, multi-host init
"""

__version__ = "0.1.0"

from .config import BuildOptions, EngineOptions, ProfileOptions  # noqa: F401
from .database import DenseTaxonomy, SlimmDatabase, build_database, tensorize  # noqa: F401
from .state import ProfileState  # noqa: F401
from .taxonomy import LINEAGE_LENGTH, Rank  # noqa: F401
