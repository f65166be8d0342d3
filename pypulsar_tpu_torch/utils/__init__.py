"""utils layer of the PyTorch/CUDA port (mirrors pypulsar_tpu/utils):
progress meter, detrending, harmonic ratios, terminal colour, receiver
gain curves, external-tool wrappers and the stage profiler."""

from pypulsar_tpu_torch.utils.progress import show_progress  # noqa: F401
from pypulsar_tpu_torch.utils.freq_at_epoch import freq_at_epoch  # noqa: F401
from pypulsar_tpu_torch.utils.ne2001 import (  # noqa: F401
    get_pulse_broadening,
    bhat_pulse_broadening,
)
from pypulsar_tpu_torch.utils import receivers  # noqa: F401
