"""Fixtures of the port's tests and smoke runs: the synthetic CHiME-5
corpus (``synthetic``), realistic reverberant scenes (``rooms``) and the
STOI metric (``metrics``) — NumPy-only copies of ``pb_chime5_tpu.testing``.
"""

from pb_chime5_tpu_torch.testing.synthetic import (
    create_synthetic_chime5, samples_to_time_str)

__all__ = ['create_synthetic_chime5', 'samples_to_time_str']
