"""sicnav_tpu_torch — the PyTorch / CUDA port of ``sicnav_tpu``.

The package mirrors ``sicnav_tpu``'s layout (``ops``, ``env``, ``policies``,
``diffusion``) so each module has an obvious twin. It imports ``torch`` and
numpy only. Entry points run on ``torch.device("cuda")`` unless the caller
passes ``device="cpu"``; with no card they raise (``device.resolve_device``).

Numerics are float32, as in the reference. TF32 would round float32 matmuls
and convolutions to about three decimal digits and break parity with the
reference, so it is turned off here for the whole process.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
