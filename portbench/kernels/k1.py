"""K1, the fused embedding rounds (``csrc/fused_embed.cu``)."""

MODULE = "svdfeature_tpu_torch.ops.cuda_embed"
WRAPPER = "train_rounds_kernel"
NAMES = ("sgd_rounds_kernel",)
# the int64 slots of its own clock (``.trace``), and how many of them hold busy ns
CLOCK = (4, 4)
