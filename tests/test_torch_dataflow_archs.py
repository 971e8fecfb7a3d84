"""The dataflow sweep of ``tests/test_torch_dataflow.py`` over its
second group of shipped reduced configs: every fixed site x replay
on / off, forward and grad traces clean.

    PYTHONPATH=src python -m pytest -q tests/test_torch_dataflow*.py
"""
import pytest

import test_torch_dataflow as df


@pytest.mark.parametrize("arch", df.ARCH_GROUPS[1])
def test_reduced_cells_trace_clean(arch):
    assert df.sweep_arch(arch) == 10
