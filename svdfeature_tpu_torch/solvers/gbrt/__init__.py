"""The GBRT solvers (extend_type 30 APLambda, 31 Reg) on PyTorch."""

from .trainer import create_gbrt_trainer, GBRTTrainer, RegGBRTTrainer, APLambdaGBRTTrainer
