"""Device half of the port: decode tables, kernels and run extraction."""

import torch

# The exact profile needs f32-faithful products: TF32 keeps ~3 decimal
# digits and would move posteriors across the IBD level thresholds. Both
# switches are set explicitly (the cuDNN one defaults to True) for every
# float32 matmul and einsum the engine runs on the card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
