"""Make a CHiME-6-style tree from a CHiME-5 tree (a test and smoke-run
fixture) — ``pb_chime5_tpu.scripts.simulate_chime6_transcriptions``
(reference pb_chime5/scripts/simulate_chime6_transcriptions.py).

The audio directory is symlinked; each transcription JSON is rewritten
with flat integer sample times on the global clock, taken from the
CHiME-5 'original' (worn) clock.

    python -m pb_chime5_tpu_torch.scripts.simulate_chime6_transcriptions \
        <chime5_dir> <chime6_dir>
"""

import json
import sys
from pathlib import Path

from pb_chime5_tpu_torch.database.create_json import to_samples
from pb_chime5_tpu_torch.io import symlink


def main(chime5_dir, chime6_dir):
    chime5_dir = Path(chime5_dir).absolute()
    chime6_dir = Path(chime6_dir).absolute()
    chime6_dir.mkdir(parents=True, exist_ok=True)

    symlink(chime5_dir / 'audio', chime6_dir / 'audio', override=True)

    for json_file in sorted(chime5_dir.glob('transcriptions/*/*.json')):
        target = chime6_dir / json_file.relative_to(chime5_dir)
        target.parent.mkdir(parents=True, exist_ok=True)
        converted = []
        for entry in json.loads(json_file.read_text()):
            entry = dict(entry)
            entry['start_time'] = to_samples(entry['start_time']['original'])
            entry['end_time'] = to_samples(entry['end_time']['original'])
            converted.append(entry)
        target.write_text(json.dumps(converted, indent=1))
        print(f'wrote {target}')


if __name__ == '__main__':
    main(*sys.argv[1:3])
