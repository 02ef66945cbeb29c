"""K5, the unique-row writer of the sorted-dedup step (``csrc/row_scatter.cu``)."""

MODULE = "svdfeature_tpu_torch.ops.cuda_scatter"
WRAPPER = "row_writer"
NAMES = ("row_write_kernel",)
CLOCK = None
