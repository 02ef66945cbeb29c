"""K4, the tile sweep of the big-table route (``csrc/tile_sweep.cu``)."""

MODULE = "svdfeature_tpu_torch.ops.cuda_sweep"
WRAPPER = "sweep_update"
NAMES = ("sweep_apply_kernel", "sweep_wide_kernel")
CLOCK = None
