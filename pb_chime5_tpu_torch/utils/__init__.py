"""Host-side helpers (NumPy / pure Python) — the port of
``pb_chime5_tpu.utils``: a keyed dict with helpful errors
(``dict_utils``), a sparse boolean activity track (``array_interval``),
sample <-> STFT-frame activity (``activity_freq``); beside them Kaldi
phone alignments (``alignment``), a subprocess wrapper
(``process_caller``), stage timing and the profiler trace
(``profiling``) and the FLOP model (``flops``).
"""

from pb_chime5_tpu_torch.utils.activity_freq import (
    activity_frequency_to_time, activity_time_to_frequency, segment_axis)
from pb_chime5_tpu_torch.utils.array_interval import (
    ArrayInterval, array_interval_from_str, array_intervals_from_rttm)
from pb_chime5_tpu_torch.utils.dict_utils import Dispatcher, merge

__all__ = ['Dispatcher', 'merge', 'ArrayInterval', 'array_interval_from_str',
           'array_intervals_from_rttm', 'segment_axis',
           'activity_time_to_frequency', 'activity_frequency_to_time']
