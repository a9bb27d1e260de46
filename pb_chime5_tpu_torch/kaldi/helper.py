"""The Kaldi environment and concurrent command execution — the port of
``pb_chime5_tpu/kaldi/helper.py`` (reference pb_chime5/kaldi/helper.py).

``KALDI_ROOT`` is read at the first call that needs it, not at import.
"""

import os
import subprocess
from pathlib import Path

__all__ = ['kaldi_root', 'get_kaldi_env', 'execute_kaldi_commands',
           'INT2SYM']

_BIN_SUBDIRS = [
    'src/bin', 'tools/openfst/bin', 'src/fstbin', 'src/gmmbin',
    'src/featbin', 'src/lm', 'src/sgmmbin', 'src/sgmm2bin', 'src/fgmmbin',
    'src/latbin', 'src/nnetbin', 'src/nnet2bin', 'src/nnet3bin',
    'src/kwsbin', 'src/online2bin', 'src/ivectorbin', 'src/lmbin',
]


def kaldi_root() -> Path:
    try:
        return Path(os.environ['KALDI_ROOT'])
    except KeyError:
        raise EnvironmentError(
            'KALDI_ROOT environment variable is not set; the Kaldi bridge '
            'needs a Kaldi installation.') from None


def wsj_eg() -> str:
    return f'{kaldi_root()}/egs/wsj/s5'


def INT2SYM() -> str:
    return f'{kaldi_root()}/egs/wsj/s5/utils/int2sym.pl'


def get_kaldi_env():
    """This process's environment with Kaldi's binaries on ``PATH``, its
    OpenFst libraries on ``LD_LIBRARY_PATH``, ``LC_ALL=C`` and one
    OpenMP thread."""
    root = kaldi_root()
    env = os.environ.copy()
    env['PATH'] += ''.join(f':{root}/{sub}' for sub in _BIN_SUBDIRS)
    env['PATH'] += f':{root}/egs/wsj/s5/utils:{root}/egs/wsj/s5/steps'
    env['PATH'] += f':{wsj_eg()}'
    openfst_lib = f'{root}/tools/openfst/lib'
    env['LD_LIBRARY_PATH'] = (
        env['LD_LIBRARY_PATH'] + ':' + openfst_lib
        if 'LD_LIBRARY_PATH' in env else openfst_lib)
    env['LC_ALL'] = 'C'
    env['OMP_NUM_THREADS'] = '1'
    return env


def execute_kaldi_commands(cmds, name='kaldi_cmd', env=None, log_dir=None,
                           inputs=None, ignore_return_code=False):
    """Run one or many Kaldi shell commands concurrently (in
    ``egs/wsj/s5``); returns (stdouts, stderrs, return codes).  A non-zero
    exit raises ``ValueError`` unless ``ignore_return_code``; ``log_dir``
    keeps each command's output (reference helper.py:43-115)."""
    cmds = cmds if isinstance(cmds, (tuple, list)) else [cmds]
    if inputs is None:
        inputs = [None] * len(cmds)
    elif not isinstance(inputs, (tuple, list)):
        inputs = [inputs]

    procs = []
    for cmd in cmds:
        kaldi_env = get_kaldi_env()
        if env is not None:
            kaldi_env.update(env)
        procs.append(subprocess.Popen(
            cmd, shell=isinstance(cmd, str), env=kaldi_env,
            universal_newlines=True, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=wsj_eg()))

    stdouts, stderrs, codes = [], [], []
    for idx, (p, inp) in enumerate(zip(procs, inputs)):
        stdout, stderr = p.communicate(input=inp)
        if log_dir is not None:
            log_dir = Path(log_dir)
            log_dir.mkdir(parents=True, exist_ok=True)
            (log_dir / f'{name}.{idx}.stdout').write_text(stdout)
            (log_dir / f'{name}.{idx}.stderr').write_text(stderr)
        if p.returncode != 0 and not ignore_return_code:
            raise ValueError(
                f'Kaldi error executing {name}.\n'
                f'Command: {cmds[idx]}\nStdout: {stdout}\nStderr: {stderr}')
        stdouts.append(stdout)
        stderrs.append(stderr)
        codes.append(p.returncode)
    return stdouts, stderrs, codes


# the reference's (misspelled) name, helper.py:43
excute_kaldi_commands = execute_kaldi_commands
