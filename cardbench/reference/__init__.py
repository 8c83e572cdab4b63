"""The plain references, one module per family (``reference/<family>.py``),
fp32 PyTorch that imports nothing of the program."""
import torch


def setup_fp32() -> None:
    """fp32 products in fp32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
