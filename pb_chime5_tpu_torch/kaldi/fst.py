"""FST text formats and compile commands — the port of
``pb_chime5_tpu/kaldi/fst.py``.

The reference's pb_chime5/kaldi/fst.py (918 LoC) is documented legacy: it
imports dead ``nt.*`` modules at fst.py:6-7 and cannot be imported
(SURVEY.md section 2, "legacy, non-importable").  This module provides a
*working* minimal equivalent of the parts with clear semantics: text-format
linear-acceptor construction and the OpenFST compile/determinize/minimize
commands, executed through the Kaldi environment.
"""

from pb_chime5_tpu_torch.kaldi import helper as kaldi_helper

__all__ = ['linear_acceptor_text', 'build_fst_compile_command',
           'compile_fst']


def linear_acceptor_text(symbols, *, weight=None):
    """Text-format linear acceptor over a symbol-id sequence.

    >>> print(linear_acceptor_text([3, 7, 7]))
    0 1 3 3
    1 2 7 7
    2 3 7 7
    3
    """
    lines = []
    for i, sym in enumerate(symbols):
        w = '' if weight is None else f' {weight}'
        lines.append(f'{i} {i + 1} {sym} {sym}{w}')
    lines.append(str(len(symbols)))
    return '\n'.join(lines)


def build_fst_compile_command(text_fst, binary_fst, *, isymbols=None,
                              osymbols=None, determinize=False,
                              minimize=False):
    """fstcompile [| fstdeterminize [| fstminimize]] command string."""
    opts = []
    if isymbols is not None:
        opts.append(f'--isymbols={isymbols}')
    if osymbols is not None:
        opts.append(f'--osymbols={osymbols}')
    cmd = f'fstcompile {" ".join(opts)} {text_fst}'
    if determinize:
        cmd += ' | fstdeterminize'
    if minimize:
        cmd += ' | fstminimize'
    return f'{cmd} > {binary_fst}'


def compile_fst(text_fst, binary_fst, **kwargs):
    cmd = build_fst_compile_command(text_fst, binary_fst, **kwargs)
    return kaldi_helper.execute_kaldi_commands(cmd, name='compile_fst')
