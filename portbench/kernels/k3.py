"""K3, the fused stacked-IMFB rounds (``csrc/fused_imfb.cu``)."""

MODULE = "svdfeature_tpu_torch.ops.cuda_imfb"
WRAPPER = "train_rounds_imfb_kernel"
NAMES = ("imfb_rounds_kernel",)
CLOCK = None
