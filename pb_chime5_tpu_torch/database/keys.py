"""Canonical example-dict key constants
(reference: pb_chime5/database/keys.py).

The port's copy of ``pb_chime5_tpu/database/keys.py``.
"""

DATASETS = 'datasets'
ALIAS = 'alias'
EXAMPLE_ID = 'example_id'
DATASET_NAME = 'dataset'

AUDIO_PATH = 'audio_path'
AUDIO_DATA = 'audio_data'
START = 'start'
END = 'end'
NUM_SAMPLES = 'num_samples'
NUM_SPEAKERS = 'num_speakers'

OBSERVATION = 'observation'
SPEECH_SOURCE = 'speech_source'
SPEECH_IMAGE = 'speech_image'
NOISE_IMAGE = 'noise_image'

SPEAKER_ID = 'speaker_id'
GENDER = 'gender'
TRANSCRIPTION = 'transcription'
KALDI_TRANSCRIPTION = 'kaldi_transcription'

# CHiME-5 specific (reference database/chime5/database.py:15-24)
WORN = 'worn'
WORN_MICROPHONE = 'worn_microphone'
TARGET_SPEAKER = 'target_speaker'
NOTES = 'notes'
SESSION_ID = 'session_id'
LOCATION = 'location'
REFERENCE_ARRAY = 'reference_array'
