"""The measure phase's full-width point on the CPU: ``qwen2-1.5b`` at
``train_4k`` on the 16x16 production mesh (fsdp, remat dots), traced on fake
tensors.  Its useful-FLOP ratio stays within ``parity.USEFUL_RATIO_REL_BOUND``
of ``parity.FULL_WIDTH_USEFUL`` (the value ``chip_smoke.py --measure`` holds
the card's trace to), and only the refusals listed for its class run an op
replicated.
The fake default process group this starts stays for the worker's life, as in
``test_torch_measure.py``.
"""
from repro_torch.configs.base import SHAPES, RunPolicy, get_config
from repro_torch.core import parity
from repro_torch.core.counters import measure_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_cell


def test_full_width_train_4k_point_on_the_production_mesh():
    cfg, shape, policy = get_config("qwen2-1.5b"), SHAPES["train_4k"], RunPolicy()
    m = measure_cell(build_cell(cfg, shape, policy, make_production_mesh()), device="cpu")
    useful = m.perf["useful_flops_ratio"]
    print(f"qwen2-1.5b train_4k 16x16: useful {useful:.4f}, trace {m.compile_s:.1f} s, "
          f"replicated {m.hlo['replicated_ops']}")
    assert abs(useful - parity.FULL_WIDTH_USEFUL) <= \
        parity.USEFUL_RATIO_REL_BOUND * parity.FULL_WIDTH_USEFUL, useful
    assert parity.unlisted_replications(m.hlo["replicated_ops"], cfg.name,
                                        policy.sharding_preset, shape.kind,
                                        policy.n_microbatch) == []
