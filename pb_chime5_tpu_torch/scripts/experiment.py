"""Minimal sacred-compatible experiment engine for the port's CLIs —
``pb_chime5_tpu.scripts.experiment.Experiment``.  Before the run dir is
made, a process launched with torchrun's variables joins the gloo process
group (``parallel/distributed.py``); the master makes the run dir and
broadcasts its id to the other processes.

* ``Experiment(name)`` with ``add_config(dict)`` /
  ``add_config_from_signature(fn)`` (every keyword of the factory
  becomes a config entry, reference scripts/run.py:19-27),
* command line ``[command] [-F DIR] with key=value ...``, values parsed
  as Python literals (else kept as strings), named configs,
* numbered run dirs ``<storage>/<run_id>/`` with ``config.json`` and
  ``run.json``, like sacred's FileStorageObserver.
"""

import ast
import datetime
import inspect
import sys
from pathlib import Path

from pb_chime5_tpu_torch.io import dump_json, load_json

__all__ = ['Experiment']


def _parse_value(text):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


class Experiment:
    def __init__(self, name, default_storage_dir='runs'):
        self.name = name
        self.config = {}
        self._named_configs = {}
        self._commands = {}
        self.default_storage_dir = Path(default_storage_dir)
        self.run_dir = None

    def add_config(self, cfg: dict):
        self.config.update(cfg)

    def add_config_from_signature(self, fn):
        for key, param in inspect.signature(fn).parameters.items():
            if param.default is not inspect.Parameter.empty:
                self.config[key] = param.default

    def named_config(self, name, cfg: dict):
        self._named_configs[name] = cfg

    def capture_kwargs(self, fn):
        """The keywords of ``fn`` that the config holds, with its values."""
        return {key: self.config[key]
                for key in inspect.signature(fn).parameters
                if key in self.config}

    def command(self, fn):
        """Register ``fn(experiment)`` as the command of its name."""
        self._commands[fn.__name__] = fn
        return fn

    def main(self, fn):
        """Register ``fn(experiment)`` as the default command."""
        self._commands['main'] = fn
        return fn

    def _create_run_dir(self, storage_dir):
        storage_dir = Path(storage_dir)
        storage_dir.mkdir(parents=True, exist_ok=True)
        while True:        # jobs started together race for the next id
            run_id = max((int(p.name) for p in storage_dir.iterdir()
                          if p.name.isdigit()), default=0) + 1
            run_dir = storage_dir / str(run_id)
            try:
                run_dir.mkdir()
                break
            except FileExistsError:
                continue
        dump_json({k: (v if isinstance(v, (int, float, str, bool, list, tuple,
                                           dict, type(None))) else repr(v))
                   for k, v in self.config.items()}, run_dir / 'config.json')
        dump_json({'experiment': self.name,
                   'start_time': datetime.datetime.now().isoformat(),
                   'command': ' '.join(sys.argv),
                   'status': 'RUNNING'}, run_dir / 'run.json')
        return run_dir

    def finalize_run(self, status='COMPLETED'):
        from pb_chime5_tpu_torch.parallel.distributed import is_master
        if self.run_dir is None or not is_master():
            return
        meta = load_json(self.run_dir / 'run.json')
        meta['status'] = status
        meta['stop_time'] = datetime.datetime.now().isoformat()
        dump_json(meta, self.run_dir / 'run.json')

    def parse_argv(self, argv=None):
        argv = list(sys.argv[1:] if argv is None else argv)
        command = 'main'
        storage_dir = self.default_storage_dir
        for flag in ('-F', '--file_storage'):
            if flag in argv:
                i = argv.index(flag)
                storage_dir = Path(argv[i + 1])
                del argv[i:i + 2]
        if argv and argv[0] != 'with' and '=' not in argv[0]:
            command = argv.pop(0)
        if argv and argv[0] == 'with':
            argv.pop(0)
        for token in argv:
            if token in self._named_configs:
                self.config.update(self._named_configs[token])
            else:
                assert '=' in token, (
                    f'Cannot parse override {token!r}; expected key=value '
                    f'or a named config out of {sorted(self._named_configs)}')
                key, value = token.split('=', 1)
                self.config[key] = _parse_value(value)
        return command, storage_dir

    @staticmethod
    def _broadcast_run_id(run_id: int) -> int:
        """The master's run id on every process (the reference bcasts the
        sacred run dir over MPI, run.py:98); as given without a process
        group."""
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size() <= 1:
            return run_id
        box = [int(run_id)]
        dist.broadcast_object_list(box, src=0)
        return int(box[0])

    def run_commandline(self, argv=None, create_run_dir=True):
        from pb_chime5_tpu_torch.parallel.distributed import (
            is_master, maybe_initialize)
        maybe_initialize()        # join torchrun's group before the run dir
        command, storage_dir = self.parse_argv(argv)
        if command not in self._commands:
            raise SystemExit(f'Unknown command {command!r}; available: '
                             f'{sorted(self._commands)}')
        if create_run_dir:
            # the master allocates the run dir; the other processes join it
            master = is_master()
            if master:
                self.run_dir = self._create_run_dir(storage_dir)
            run_id = self._broadcast_run_id(
                int(self.run_dir.name) if master else -1)
            if not master:
                self.run_dir = Path(storage_dir) / str(run_id)
            print(f'Experiment dir: {self.run_dir}')
        print('Configuration:')
        for key in sorted(self.config):
            print(f'  {key} = {self.config[key]!r}')
        try:
            result = self._commands[command](self)
        except BaseException:
            self.finalize_run('FAILED')
            raise
        self.finalize_run('COMPLETED')
        return result
