"""Multi-device layer: dp / sp / tp meshes over ranks that are processes.

Counterpart of ``animal_vision_tpu/parallel/``. Ranks are processes in a
``torch.distributed`` process group (``launch.spawn``); ``comm`` moves
tensors between them. Importing the package starts no process and creates
no process group.
"""

from animal_vision_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    shard_batch,
    sharded_inference_fn,
)
