"""tools/design_sweep.py builds each variant from a kernel source with some
constants rewritten. On the CPU the rewriting is checked against the real
sources: each variant changes exactly the lines of its constants, to the
values it names; the kernels themselves run only on the card."""

import pytest

from lingodb_tpu_torch.ops import cuda_build
from lingodb_tpu_torch.tools import design_sweep as ds


@pytest.mark.parametrize("key", list(ds.VARIANTS), ids="_".join)
def test_variant_rewrites_only_its_constants(key):
    name, _ = key
    consts = ds.VARIANTS[key]
    text = ds.kernel_source(name)  # the shared headers inlined
    new = ds.variant_source(text, consts)
    old_lines, new_lines = text.splitlines(), new.splitlines()
    assert len(old_lines) == len(new_lines)
    changed = [(a, b) for a, b in zip(old_lines, new_lines) if a != b]
    assert len(changed) == len(consts)
    for (_, line), (const, value) in zip(changed, consts.items()):
        assert f" {const} = {value};" in line


def test_variant_of_a_missing_constant_is_refused():
    text = (cuda_build.CSRC / "tile_gather.cu").read_text()
    with pytest.raises(ValueError):
        ds.variant_source(text, {"kNoSuchConstant": "1"})
