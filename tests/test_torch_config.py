"""The port's own config schema (rslo_tpu_torch.config.schema) against
the JAX package's: the same dataclasses, field names, defaults and
nesting; the shipped configs load to equal dicts in both; grid_size
agrees."""
import dataclasses
import json
import os

import pytest

from rslo_tpu.config import schema as jax_schema
from rslo_tpu_torch.config import schema as port_schema

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ("VoxelizerCfg", "VFECfg", "MiddleCfg", "OdomCfg", "LossCfg",
           "DataCfg", "OptimizerCfg", "TrainCfg", "PipelineCfg")


@pytest.mark.parametrize("name", CLASSES)
def test_schema_equals_jax_field_by_field(name):
    port_cls, jax_cls = getattr(port_schema, name), getattr(jax_schema, name)
    assert dataclasses.is_dataclass(port_cls)
    assert port_cls.__dataclass_params__.frozen
    got = [(f.name, str(f.type)) for f in dataclasses.fields(port_cls)]
    want = [(f.name, str(f.type)) for f in dataclasses.fields(jax_cls)]
    assert got == want
    # defaults, nested dataclasses included, as plain dicts
    assert dataclasses.asdict(port_cls()) == dataclasses.asdict(jax_cls())


@pytest.mark.parametrize("config", ["kitti_eval_ours.json",
                                    "kitti_train_ours.json"])
def test_shipped_configs_round_trip(config):
    with open(os.path.join(REPO, "configs", config)) as fh:
        text = fh.read()
    port = port_schema.PipelineCfg.from_json(text)
    ref = jax_schema.PipelineCfg.from_json(text)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    again = port_schema.PipelineCfg.from_json(port.to_json())
    assert again == port
    assert json.loads(port.to_json()) == json.loads(ref.to_json())
    assert port_schema.grid_size(port.voxelizer) == \
        jax_schema.grid_size(ref.voxelizer) == (1408, 768, 40)
    # nested sections are the port's own classes
    assert type(port.middle) is port_schema.MiddleCfg
    assert port.replace(middle=dataclasses.replace(
        port.middle, engine="band")).middle.engine == "band"


def test_from_dict_rejects_unknown_keys():
    with pytest.raises(KeyError, match="MiddleCfg.nope"):
        port_schema.PipelineCfg.from_dict({"middle": {"nope": 1}})
