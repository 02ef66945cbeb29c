"""K6, the row reader (``csrc/row_scatter.cu``)."""

MODULE = "svdfeature_tpu_torch.ops.cuda_scatter"
WRAPPER = "row_reader"
NAMES = ("row_read_kernel",)
CLOCK = None
