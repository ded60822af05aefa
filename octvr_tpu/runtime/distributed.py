"""Multi-host (multi-process) runtime support.

The reference is single-host (SURVEY.md §2.5: no MPI/NCCL anywhere); the
scaling design here replaces its 5-thread pipeline with a JAX process
group across hosts + a ('data', 'space') device mesh:

* every host runs the same program (SPMD) after
  :func:`init_distributed`;
* frames fan out on the 'data' axis — each host reads/decodes its own
  slice of the stream locally and contributes it with
  :func:`global_frame_batch` (no frame bytes cross hosts; only the
  tiny gain psum and the 'space'-axis level-L gather ride the
  interconnect);
* the stitched output is fetched per host via
  ``jax.experimental.multihost_utils`` or addressable shards.

Single-process fallback: every function below degrades to the local
devices when ``jax.process_count() == 1``, so the same driver script
runs on a laptop, one multi-card host, or a cluster.
"""

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "init_distributed",
    "make_global_mesh",
    "global_frame_batch",
    "local_output_shards",
]


def init_distributed(
    coordinator_address=None,
    num_processes=None,
    process_id=None,
    local_device_ids=None,
):
    """Initialize the JAX process group (jax.distributed).  Pass the
    coordinator ``host:port`` + process counts explicitly where the
    environment does not describe the cluster.
    No-op if the group is already initialized or single-process args
    are given."""
    if num_processes == 1:
        return False
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
        return True
    except RuntimeError as e:  # already initialized
        if "already" in str(e).lower():
            return False
        raise


def make_global_mesh(n_data=None, n_space=1, devices=None):
    """('data', 'space') mesh over the GLOBAL device list.  'space'
    shards should map to devices within a host/ICI domain (fast halo &
    psum); 'data' spans hosts over DCN (frames are independent, so DCN
    only carries control).  Defaults: use every global device for
    'data'."""
    devices = devices if devices is not None else jax.devices()
    if n_data is None:
        n_data = len(devices) // n_space
    assert n_data * n_space <= len(devices)
    dev = np.array(devices[: n_data * n_space]).reshape(n_data, n_space)
    return Mesh(dev, axis_names=("data", "space"))


def global_frame_batch(local_frames, mesh):
    """Assemble a global ['data'-sharded] frame batch from each process's
    locally produced frames (u8 [B_local, ncam, Hf*3/2, Wf]).  Every
    process contributes its own slice; no frame bytes cross DCN."""
    local_frames = np.asarray(local_frames)
    sharding = NamedSharding(mesh, P("data"))
    if jax.process_count() == 1:
        return jax.device_put(local_frames, sharding)
    from jax import make_array_from_process_local_data

    return make_array_from_process_local_data(sharding, local_frames)


def local_output_shards(out):
    """The stitched shards owned by this process, as (index, ndarray)
    pairs — each host writes/encodes only its own frames."""
    return [
        (s.index, np.asarray(s.data)) for s in out.addressable_shards
    ]
