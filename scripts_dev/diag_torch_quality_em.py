"""The realistic scenes' quality (``tests/test_realistic_scene.py``) at
two EM lengths, through the PyTorch port and through the JAX package, on
the CPU: whether a gap between the 10-iteration chain (the one the JAX
test pins) and the default 20 + 1 EM belongs to the port or to the
algorithm.

    JAX_PLATFORMS=cpu python scripts_dev/diag_torch_quality_em.py [--seeds 0 1 2]

For each seed and each of ``bss_iterations`` 10 and 20 (``iterations_post``
1, the default): SIR gains (bf-only, mask_mul) and STOI (mask_mul in the
overlap, minus raw there, minus bf over the span) of both packages' chains
on the same scene (the port's copy of ``testing/rooms.py``; both packages
make the same scene from a seed), then their medians.  Prints one JSON
line per (package, EM length, seed) and one per (package, EM length)
with the medians.  Takes ~5 minutes for three seeds.
"""

import argparse
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pb_chime5_tpu.models.gss import GssConfig as JaxGssConfig  # noqa: E402
from pb_chime5_tpu.models.gss import gss_enhance as jax_gss_enhance  # noqa: E402,E501
from tests.test_torch_realistic_scene import (  # noqa: E402
    chain_quality, make_scene, medians)


def jax_chain_quality(scene, **config):
    """``chain_quality`` with the JAX package's chain in place of the
    port's (the same regions and metrics)."""
    import tests.test_torch_realistic_scene as port_test

    def jax_enhance(obs, act, target, config):
        cfg = JaxGssConfig(**{f: getattr(config, f) for f in (
            'bss_iterations', 'bss_iterations_post', 'postfilter')})
        x, _ = jax_gss_enhance(jnp.asarray(obs.numpy()),
                               jnp.asarray(act.numpy()),
                               jnp.int32(target), config=cfg)
        return torch.from_numpy(np.array(x)), None

    real = port_test.gss_enhance
    port_test.gss_enhance = jax_enhance
    try:
        return chain_quality(scene, **config)
    finally:
        port_test.gss_enhance = real


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--seeds', type=int, nargs='+', default=[0, 1, 2])
    args = parser.parse_args()
    jax.config.update('jax_platforms', 'cpu')
    torch.set_num_threads(4)
    scenes = {seed: make_scene(seed) for seed in args.seeds}
    for iterations in (10, 20):
        for package, fn in (('port', chain_quality),
                            ('jax', jax_chain_quality)):
            per_seed = {}
            for seed, scene in scenes.items():
                per_seed[seed] = fn(scene, bss_iterations=iterations)
                print(json.dumps({'package': package, 'em': iterations,
                                  'seed': seed, **per_seed[seed]}),
                      flush=True)
            print(json.dumps({'package': package, 'em': iterations,
                              'medians': medians(per_seed)}), flush=True)


if __name__ == '__main__':
    main()
