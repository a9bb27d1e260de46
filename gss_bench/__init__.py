"""The benchmark of ``pb_chime5_tpu_torch``: synthetic CHiME-5 sessions
through ``Enhancer.enhance_session`` on one card or, one rank process a
card, on several (``gss_bench/ranks.py``), each cell checked
against a float64 plain-PyTorch reference (``gss_bench/reference``).

Run one cell: ``python -m gss_bench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the repository root.
"""
