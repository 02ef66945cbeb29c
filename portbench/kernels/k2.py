"""K2, the fused SVD++ rounds (``csrc/fused_svdpp.cu``)."""

MODULE = "svdfeature_tpu_torch.ops.cuda_svdpp"
WRAPPER = "train_rounds_svdpp_kernel"
NAMES = ("svdpp_rounds_kernel",)
# the int64 slots of its own clock (``.trace``), and how many of them hold busy ns
CLOCK = (9, 8)
