"""Data and tensor parallelism over several processes (``torch.distributed``):
the counterpart of ``aa_clip_iqm_tpu/parallel``. :mod:`.mesh` lays ranks out
on named axes and splits batches and backbone weights, :mod:`.multihost`
starts the runtime and says which rows a rank loads, and :mod:`.collectives`
holds the sums and gathers that the steps, the blocks and the predict
program make."""
from . import collectives, mesh, multihost  # noqa: F401
