"""The Kaldi bridge (host only, through subprocesses) — the port of
``pb_chime5_tpu.kaldi`` (reference pb_chime5/kaldi/).

Every call shells out to Kaldi binaries found through the ``KALDI_ROOT``
environment variable; importing the package needs no Kaldi, the first
call that runs a tool does (``helper.kaldi_root`` raises
``EnvironmentError`` without it).
"""

from pb_chime5_tpu_torch.kaldi import (  # noqa: F401
    alignment, decode, fst, helper, io, transcription)
