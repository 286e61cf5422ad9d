"""Config parity: the port's configs equal the JAX package's, field by field."""
import dataclasses

import pytest

from repro.configs import all_archs as ref_archs
from repro.configs import base as ref_base
from repro_torch.configs import all_archs as port_archs
from repro_torch.configs import base as port_base

ARCHS = ref_base.list_archs()


def test_registries_list_the_same_archs():
    assert port_base.list_archs() == ARCHS
    assert len(ARCHS) == 10


@pytest.mark.parametrize("variant", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_asdict_matches_reference(arch, variant):
    if variant == "full":
        ref, port = ref_base.get_config(arch), port_base.get_config(arch)
    else:
        ref, port = ref_archs.smoke_config(arch), port_archs.smoke_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.attn_free == ref.attn_free
    assert port.subquadratic == ref.subquadratic
    assert port_base.default_preset(port) == ref_base.default_preset(ref)


def test_run_policy_and_shapes_match_reference():
    assert dataclasses.asdict(port_base.RunPolicy()) == \
        dataclasses.asdict(ref_base.RunPolicy())
    assert {k: dataclasses.asdict(v) for k, v in port_base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_base.SHAPES.items()}
    with pytest.raises(NotImplementedError, match="sharding: later slice"):
        port_base.RunPolicy().rules_dict()
