"""``subprocess.run`` with the captured output in the error — the port of
``pb_chime5_tpu/utils/process_caller.py`` (reference
pb_chime5/utils/process_caller.py)."""

import os
import subprocess

__all__ = ['run_process']

DEBUG_MODE = False


def run_process(cmd, *, shell=None, check=True, environment=None, cwd=None,
                input=None, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                universal_newlines=True):
    """Run a command; on failure raise ``CalledProcessError`` whose message
    holds the captured stdout and stderr.  ``shell`` defaults to the type
    of ``cmd`` (a string runs in a shell, a list is executed)."""
    if shell is None:
        shell = isinstance(cmd, str)
    if environment is None:
        environment = os.environ
    try:
        return subprocess.run(
            cmd, input=input, universal_newlines=universal_newlines,
            shell=shell, stdout=stdout, stderr=stderr, check=check,
            env=environment, cwd=cwd)
    except subprocess.CalledProcessError as e:
        raise subprocess.CalledProcessError(
            returncode=e.returncode,
            cmd=f'{e.cmd}\n\nstdout:\n{e.stdout}\n\nstderr:\n{e.stderr}',
            output=e.output, stderr=e.stderr) from None
