"""The multi-chip path (port of ``icd_tpu/parallel/``): process groups laid
out as the JAX package's (data, model) mesh (``mesh.py``), the
vocab-parallel embedding and output projection that XLA's collectives
give the JAX package for free (``vocab.py``), and a multi-rank dryrun
on the CPU (``dryrun.py``)."""

from .mesh import (Mesh, assert_replicated, batch_layout,  # noqa: F401
                   batch_rows, decoder_param_specs, gather_batch,
                   init_distributed, make_data_mesh, make_mesh, run_ranks,
                   shard_batch)
from .vocab import shard_decoder, unshard_decoder  # noqa: F401
