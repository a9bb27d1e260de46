"""Deployments: what one corpus layout and one enhancer factory need of
the harness, one module a deployment, ``gss_bench/deployments/<name>.py``,
which a configuration names under ``deployment_module`` (``chime5`` where
it names none) and ``run.load_deployment`` loads by its path.  A module
defines:

* ``corpus_dir``: the corpus's directory name inside a run's work
  directory;
* ``write_corpus(root, config, traffic, seed, device)``: the session's
  files under ``root``, laid out from ``gss_bench/corpus.py``'s turns and
  array signals;
* ``load_session(root, config)``: the reference's reading of them ->
  ({example_id: ``reference.session.Utterance``}, {array: {speaker:
  [(start, stop)]}}), from the files alone;
* ``open_enhancer(workdir, root, config, device)``: the program's
  database of ``root`` written in ``workdir`` and its enhancer on it, not
  yet warmed up;
* ``session_time(ex)``: a program example's position on the session
  timeline, the order a call enhances in.

Loading the module, ``write_corpus`` and ``load_session`` load neither the
program nor JAX: the module imports the program inside ``open_enhancer``
only.
"""

import numpy as np

__all__ = ['enhancer_kwargs']


def enhancer_kwargs(config):
    """The configuration's ``enhancer`` settings as a factory's keywords."""
    kwargs = dict(config['enhancer'])
    kwargs['compute_dtype'] = np.dtype(kwargs.get('compute_dtype',
                                                  'float32')).type
    if 'length_buckets' in kwargs and kwargs['length_buckets'] is not None:
        kwargs['length_buckets'] = tuple(kwargs['length_buckets'])
    return kwargs
