"""octvr_tpu — JAX/XLA panoramic video stitching and camera-rig
calibration engine.

A from-scratch re-design of the capabilities of blahgeek/OpenCV-octVR:

* offline: camera models -> template compiler (remap tables, masks, seams,
  vignette) -> versioned template files (VRv11-compatible)
* online: jitted per-frame stitch (YUV420 -> remap gather -> gain
  compensation -> feather / multiband blend -> YUV420), sharded over
  device meshes with shard_map
* registration: features, matching, homography, bundle adjustment, wave
  correction (JAX autodiff)
"""

__version__ = "0.1.0"
