"""Host-side math helpers."""
from pb_chime5_tpu_torch.math.solve import stable_solve
