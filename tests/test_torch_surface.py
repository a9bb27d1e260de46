"""The port's surface against the JAX package's: for every module of
``pb_chime5_tpu``, every public name (no leading ``_``) that the module
defines at its top level (a ``def``, a ``class``, an assignment, also
inside a top-level ``try`` or ``if``, not in the ``__main__`` block) has
a counterpart of the same name in the port's module at the same path,
and every public member of such a class has one on the port's class.
Inner functions (``parallel/mesh.py``'s ``per_device``) are not names of
a module and are not compared.  The only exceptions are ``EXCLUDED``,
each with its reason; the Pallas modules' exported kernels have their
counterparts in ``pb_chime5_tpu_torch/ops/kernels/`` (``KERNEL_MODULES``).

The JAX package's sources are read with ``ast``; the port's modules are
imported.
"""

import ast
import importlib
from pathlib import Path

import pytest

import pb_chime5_tpu

JAX_ROOT = Path(pb_chime5_tpu.__file__).parent

PALLAS = 'Pallas TPU kernel module: its kernels are ops/kernels/ entries'
COMPILE_CACHE = ("XLA's compile cache: the port's kernels are nvcc builds "
                 "cached by source hash (ops/kernels/_build.py)")
V5E = "a TPU v5e peak rate: the port's FLOP model reads the H100's"
# (module under the package, name or None for the whole module) -> reason
EXCLUDED = {
    ('ops.pallas', None): PALLAS,
    ('ops.pallas.chol_solve', None): PALLAS,
    ('ops.pallas.fused_em', None): PALLAS,
    ('ops.pallas.gj_inverse2d', None): PALLAS,
    ('ops.pallas.hermitian_inverse', None): PALLAS,
    ('ops.pallas.wpe_stats', None): PALLAS,
    ('models.gss', 'machine_cache_scope'): COMPILE_CACHE,
    ('models.gss', 'enable_persistent_compilation_cache'): COMPILE_CACHE,
    ('utils.flops', 'V5E_PEAK_TFLOPS_BF16'): V5E,
    ('utils.flops', 'V5E_PEAK_TFLOPS_F32_6PASS'): V5E,
}
# Pallas module -> the port's module of its kernels' counterparts
KERNEL_MODULES = {
    'chol_solve': 'chol_solve', 'fused_em': 'fused_em',
    'gj_inverse2d': 'gj_inverse', 'hermitian_inverse': 'gj_inverse',
    'wpe_stats': 'wpe_stats'}


def module_name(path):
    parts = path.relative_to(JAX_ROOT).with_suffix('').parts
    if parts[-1] == '__init__':
        parts = parts[:-1]
    return '.'.join(parts)


MODULES = sorted(module_name(p) for p in JAX_ROOT.rglob('*.py'))


def targets(node):
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return [node.name]
    return []


def top_level(body):
    """The top-level statements, those of top-level ``try`` / ``if``
    blocks included."""
    for node in body:
        if isinstance(node, ast.Try):
            yield from top_level(node.body + node.orelse + node.finalbody)
            for handler in node.handlers:
                yield from top_level(handler.body)
        elif isinstance(node, ast.If):
            if "id='__name__'" in ast.dump(node.test):
                continue                   # the script block: no import
            yield from top_level(node.body + node.orelse)
        else:
            yield node


def jax_surface(module):
    """{public name: public member names (a class) or None}."""
    path = JAX_ROOT.joinpath(*module.split('.')) if module else JAX_ROOT
    path = path / '__init__.py' if path.is_dir() else path.with_suffix('.py')
    out = {}
    for node in top_level(ast.parse(path.read_text()).body):
        for name in targets(node):
            if name.startswith('_'):
                continue
            members = None
            if isinstance(node, ast.ClassDef):
                members = [m for n in node.body for m in targets(n)
                           if not m.startswith('_')]
            out[name] = members
    return out


def port_module(module):
    return importlib.import_module(
        'pb_chime5_tpu_torch' + (f'.{module}' if module else ''))


@pytest.mark.parametrize('module', MODULES, ids=lambda m: m or '<package>')
def test_public_names_have_port_counterparts(module):
    if (module, None) in EXCLUDED:
        return
    port = port_module(module)
    missing = []
    for name, members in jax_surface(module).items():
        if (module, name) in EXCLUDED:
            continue
        if not hasattr(port, name):
            missing.append(name)
            continue
        cls = getattr(port, name)
        fields = getattr(cls, '__dataclass_fields__', {})
        missing += [f'{name}.{m}' for m in members or ()
                    if not hasattr(cls, m) and m not in fields]
    assert not missing, f'{module}: {missing}'


def test_exclusions_name_what_exists():
    """Every exclusion names a module (and a name) of the JAX package and
    gives a reason; none names something the port has after all."""
    for (module, name), reason in EXCLUDED.items():
        assert module in MODULES and reason
        if name is not None:
            assert name in jax_surface(module), (module, name)
            assert not hasattr(port_module(module), name), (module, name)


@pytest.mark.parametrize('pallas', sorted(KERNEL_MODULES))
def test_pallas_kernels_have_kernel_counterparts(pallas):
    """Each name a Pallas module exports (its ``__all__``) is an entry of
    the port's kernel module."""
    source = JAX_ROOT / 'ops' / 'pallas' / f'{pallas}.py'
    exported = next(
        ast.literal_eval(node.value)
        for node in ast.parse(source.read_text()).body
        if isinstance(node, ast.Assign) and targets(node) == ['__all__'])
    kernels = importlib.import_module(
        f'pb_chime5_tpu_torch.ops.kernels.{KERNEL_MODULES[pallas]}')
    assert exported and all(hasattr(kernels, n) for n in exported), exported
