import glob
import os

import pytest

from rgbd_pose_estimation_tpu.utils.config import (
    PipelineConfig,
    RansacConfig,
    load_yaml_config,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class TestConfig:
    def test_all_checked_in_configs_parse(self):
        paths = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
        assert len(paths) == 5  # the five driver configs
        for p in paths:
            cfg = load_yaml_config(p)
            assert isinstance(cfg, PipelineConfig)

    def test_values_round_trip(self):
        cfg = load_yaml_config(
            os.path.join(REPO, "configs", "config2_ransac_pnp_pair.yaml")
        )
        assert cfg.ransac.num_hypotheses == 2048
        assert cfg.ransac.threshold == 0.01
        assert cfg.ransac.prosac is True

    def test_tuple_values(self):
        cfg = load_yaml_config(
            os.path.join(REPO, "configs", "config3_dense_icp_odometry.yaml")
        )
        # (3,4,6) gave equal-or-better hard-mode ATE than the classic
        # (5,7,10).
        assert cfg.icp.iters_per_level == (3, 4, 6)

    def test_unknown_key_raises(self, tmp_path):
        p = tmp_path / "bad.yaml"
        p.write_text("ransac:\n  nonexistent_key: 3\n")
        with pytest.raises(TypeError):
            load_yaml_config(p)

    def test_unknown_section_raises(self, tmp_path):
        p = tmp_path / "bad2.yaml"
        p.write_text("wat:\n  x: 1\n")
        with pytest.raises(ValueError):
            load_yaml_config(p)

    def test_configs_are_hashable_static_args(self):
        assert hash(RansacConfig()) == hash(RansacConfig())
        assert RansacConfig() == RansacConfig()
