"""The 17-step pipeline in both packages from two more seeds at 640 x 640,
with the helpers and tolerances of tests/test_torch_pipeline.py: seed 4,
which runs through, and seed 0, on which both packages' step 15 raises the
warp planner's refusal of a region scaled too far (ops/warp_mxu.py), a
behaviour of the reference that the port keeps.
"""
import pytest
import torch

from tests.test_torch_pipeline import (  # noqa: F401 (fixtures)
    assert_kd_queries_are_sklearns,
    assert_pipeline_matches,
    kd_queries,
    pipeline_assets,
    run_step_pair,
    step_pair,
)

torch.set_num_threads(1)


def test_pipeline_matches_the_reference_seed_4(step_pair, kd_queries):
    differ = assert_pipeline_matches(step_pair, 4)
    assert differ['PageTextRegionStep'] < 100
    assert assert_kd_queries_are_sklearns(kd_queries) == (5135, 83, 31)


def test_both_packages_refuse_the_same_warp_seed_0(step_pair):
    done = []
    with pytest.raises(AssertionError,
                       match='warp too close to a 90-degree rotation'):
        for name, _, _ in run_step_pair(step_pair, 0):
            done.append(name)
    assert len(done) == 14 and done[-1] == 'PageCroppingStep'
