"""cellranger_tpu: a single-cell sequencing engine on JAX.

A from-scratch JAX/XLA re-design of the capabilities of 10x Genomics
Cell Ranger (reference: Schaudge/cellranger): barcode correction, splice-aware
read alignment, UMI deduplication, feature x barcode count matrices, cell
calling, secondary analysis, and V(D)J assembly -- with the hot paths running
as fixed-shape batched device computations under jit, and multi-device
scaling expressed through jax.sharding meshes and XLA collectives instead of
the reference's Martian process pipeline.
"""

__version__ = "0.1.0"
