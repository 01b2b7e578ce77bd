"""The path kernels' design choice (ops/cuda_megakernel.DESIGN_BY_WIDTH):
every node table the port packs has a design the kernels build, the wrappers
take it when no design is named, and a name the kernels do not build raises.
JAX-free; the two designs themselves run on the card only (chip_smoke.py
times them against each other and holds their sums byte-equal)."""
import pytest

from pathtracing_tpu_torch.accel.wide import LAYOUTS_BY_WIDTH
from pathtracing_tpu_torch.ops import cuda_megakernel as CM

# 0 is the binary nl8 table; the others are the mega-tables by row width
WIDTHS = (0, *sorted(LAYOUTS_BY_WIDTH))


@pytest.mark.parametrize("width", WIDTHS)
def test_every_node_table_has_a_built_design(width):
    assert CM.DESIGN_BY_WIDTH[width] in CM.DESIGNS
    assert CM.design_code(width, None) == CM.DESIGNS.index(CM.DESIGN_BY_WIDTH[width])


def test_the_table_kinds_take_their_measured_designs():
    # binary: the first design; every mega-table: the wide block (PERF.md)
    assert set(CM.DESIGN_BY_WIDTH) == set(WIDTHS)
    assert CM.DESIGN_BY_WIDTH[0] == "first"
    assert {CM.DESIGN_BY_WIDTH[w] for w in LAYOUTS_BY_WIDTH} == {"wide"}


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", CM.DESIGNS)
def test_a_named_design_overrides_the_table(width, name):
    assert CM.design_code(width, name) == CM.DESIGNS.index(name)


@pytest.mark.parametrize("name", ["staged", "auto", "", "Wide"])
def test_a_design_the_kernels_do_not_build_raises(name):
    with pytest.raises(ValueError):
        CM.design_code(WIDTHS[1], name)
