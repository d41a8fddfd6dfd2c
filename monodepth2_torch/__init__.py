"""monodepth2_torch — the PyTorch/CUDA port of monodepth2_tpu.

The JAX package beside it stays the reference: every module here mirrors the
module of the same name there (``ops/geometry.py`` ↔
``monodepth2_tpu/ops/geometry.py``), keeps its public tensor layouts (NHWC
images, (N, L, H, W, C) frame stacks, (N, P, 2) uv) and is held against it by
the ``tests/test_torch_*.py`` parity tests. Inside, the models run NCHW.

This package imports torch and never jax, optax or monodepth2_tpu. Its entry
points run on the card (``device="cuda"``) unless the caller asks for the
CPU, where the hand-written CUDA kernels give way to their plain PyTorch
versions.

Layout:
  ops/       geometry, SSIM, losses, the grid-sample op; ops/cuda/ holds the
             hand-written Hopper kernels and their ctypes binding
  nn/        Conv (reflect or zero padding), BatchNorm, pools, upsampling
  models/    ResNet encoder, DepthDecoder, PoseDecoder, Model
  training/  config, multi-scale loss, train state, the eager and the scanned
             (CUDA-graph) step, checkpoint, the fit loop (one process, or one
             rank of a data-parallel mesh)
  parallel/  data parallelism across processes: the mesh over a process
             group's ranks (one card each), the GSPMD- and shard_map-semantics
             steps, the process group's set-up, per-process input sharding
  data/      datasets (KITTI, Depth10k, DChain, synthetic), the native image
             decoder (native/mdloader.cpp, built here) with PIL where it does
             not build, the loader and the pinned copy to the card
  utils/     step timing, the profiler hook, PNG output, depth metrics
  bridge.py  JAX params/stats pytree <-> the port's state_dict, and the JAX
             package's checkpoints read without jax
  eval.py    batched inference from a checkpoint of either package, disparity
             PNGs, the median-scaled depth accuracy
  serving.py the torch.export artifact: export, load (no model code), call
  server.py  the micro-batching HTTP server over an artifact
  tools/     measurement entry points and the convergence experiment
"""

__version__ = "0.1.0"
