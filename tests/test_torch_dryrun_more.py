"""The port's dry run on the meta device, the last six archs of the
registry: every shape at baseline and HQP at decode_32k, held against the
JAX package's dry run cell by cell (``_torch_dryrun_common.check_cell``;
the first four and the CLI are in ``test_torch_dryrun.py``)."""
import pytest

from _torch_dryrun_common import cells, check_cell, one_thread  # noqa: F401
from repro_torch import configs

ARCHS = configs.list_archs()[4:]


@pytest.mark.parametrize("arch,shape,variant", cells(ARCHS))
def test_cell_matches_reference(arch, shape, variant):
    check_cell(arch, shape, variant)
