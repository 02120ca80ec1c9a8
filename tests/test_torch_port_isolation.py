"""The port stands alone: no module of dgvcc_tpu_torch imports JAX, flax,
optax, msgpack (the card's machine has none of them; the port reads the
JAX package's checkpoints with its own reader) or the JAX package, and
its entry points never fall back to the CPU on their own. What the port
refuses points at an item of ROADMAP.md's Queue 1 that exists, and the
count of configs it runs is the one ROADMAP.md states."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "dgvcc_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "optax", "msgpack", "dgvcc_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _banned(name):
    return any(name == b or name.startswith(b + ".") for b in BANNED)


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 12
    bad = [(str(f.relative_to(REPO)), n) for f in files for n in _imports(f)
           if _banned(n)]
    assert not bad, bad


def test_importing_every_module_loads_no_jax():
    mods = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  for p in PORT.rglob("*.py") if p.name != "__main__.py")
    code = ("import sys\nbefore = set(sys.modules)\n"
            + "".join(f"import {m}\n" for m in mods)
            + "new = set(sys.modules) - before\n"
            f"bad = sorted(m for m in new if m.split('.')[0] in {BANNED!r})\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is absent")
    from dgvcc_tpu_torch.serve import VideoCounter, resolve_device
    from dgvcc_tpu_torch.train.state import create_train_state

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VideoCounter.from_checkpoint("final", None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_train_state(torch.nn.Linear(2, 1), {"name": "adamw"})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VideoCounter(torch.nn.Identity())
    with pytest.raises(ValueError):
        resolve_device("mps")
    assert resolve_device("cpu").type == "cpu"


def test_trainer_counter_and_dmap_cli_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is absent")
    from dgvcc_tpu_torch.core.config import Config
    from dgvcc_tpu_torch.data import dmap_cli
    from dgvcc_tpu_torch.ops.tiling import TiledCounter
    from dgvcc_tpu_torch.train.trainer import DGTrainer

    cfg = Config.from_dict({"device": "tpu", "log_dir": str(tmp_path)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DGTrainer(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TiledCounter(torch.nn.Linear(2, 1), 1000.0, 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dmap_cli.generate([])
    assert TiledCounter(torch.nn.Linear(2, 1), 1000.0, 64, device="cpu").device.type == "cpu"


def test_serving_extras_and_regressors_default_to_cuda_and_raise_without_it(tmp_path):
    """The CLI's --http, the fleet's replicas (no --device: the config's,
    here tpu, which reads as cuda) and the regressors, in serving and in
    the trainer."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is absent")
    import yaml

    from dgvcc_tpu_torch.cli.main import run
    from dgvcc_tpu_torch.core.config import Config
    from dgvcc_tpu_torch.serve import VideoCounter
    from dgvcc_tpu_torch.serve_fleet import FleetServer
    from dgvcc_tpu_torch.train.trainer import DGTrainer

    cfg = {"device": "tpu", "model": {"name": "final", "params": {}},
           "log_dir": str(tmp_path / "logs")}
    path = tmp_path / "c.yml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(str(path), "serve", http=0, block=False)
    fleet = FleetServer(str(path), replicas=1, port=0, probe_s=0.2)
    assert "--device" not in fleet.replicas[0].make_cmd(1)
    with pytest.raises(RuntimeError, match="exited before becoming ready"):
        fleet.start(ready_timeout=120)
    assert not fleet.replicas[0].alive() and fleet.replicas[0].proc.returncode != 0
    for name in ("dgnet", "dgnet_cls", "reg", "reg_mem"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            VideoCounter.from_checkpoint(name, None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DGTrainer(Config.from_dict(dict(cfg, model={"name": "dgnet"}, mode="discrimination")))


def _queue1_items():
    text = (REPO / "ROADMAP.md").read_text()
    queue = text[text.index("### Queue 1"):text.index("### Queue 2")]
    return {int(n) for n in re.findall(r"^(\d+)\. \*\*", queue, flags=re.M)}


def test_every_queue_1_item_the_port_cites_exists():
    """Literal "Queue 1 item N" in the port's files and chip_smoke.py."""
    items = _queue1_items()
    assert items == set(range(1, len(items) + 1)) and len(items) >= 3
    cited = {}
    for f in sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for n in re.findall(r"Queue 1 items? (\d+)", f.read_text()):
            cited.setdefault(int(n), []).append(str(f.relative_to(REPO)))
    assert cited and not {n: w for n, w in cited.items() if n not in items}


def _runs_in_the_port(path):
    """Whether the config names only ported pieces: no refused key, and a
    registered mode, model family, loss and dataset."""
    import dgvcc_tpu_torch.data  # noqa: F401
    import dgvcc_tpu_torch.losses  # noqa: F401
    import dgvcc_tpu_torch.models  # noqa: F401
    from dgvcc_tpu_torch.core.config import load_config
    from dgvcc_tpu_torch.core.registry import DATASETS, LOSSES, MODELS
    from dgvcc_tpu_torch.train.steps import MODES
    from dgvcc_tpu_torch.train.trainer import check_ported

    cfg = load_config(path)
    try:
        check_ported(cfg)
    except NotImplementedError:
        return False
    specs = [getattr(cfg, f"{s}_dataset") for s in ("train", "val", "test")]
    return (cfg.model.get("name") in MODELS and cfg.mode in MODES
            and cfg.loss.get("name") in LOSSES
            and all(s is None or s["name"] in DATASETS for s in specs))


WHITENING_BASELINES = sorted(
    str(p.relative_to(REPO)) for p in (REPO / "configs" / "baselines").glob("*.yml")
    if re.search(r"_(sw|ibn|isw)\.yml$", p.name))


REGRESSOR_CONFIGS = ["configs/mall_base.yml", "configs/sta_dis.yml", "configs/sta_reg.yml",
                     "configs/sta_reg_base.yml", "configs/stb_reg.yml",
                     "configs/stb_reg_base.yml"]


GENERATOR_CONFIGS = ["configs/sta_gen.yml", "configs/sta_joint.yml", "configs/stb_gen.yml",
                     "configs/stb_joint.yml"]
CLASSIC_BASELINES = ["configs/baselines/jhu_fog2snow_bl.yml", "configs/baselines/sta_bl.yml",
                     "configs/baselines/sta_cctrans.yml", "configs/baselines/sta_csrnet.yml",
                     "configs/baselines/sta_dssinet.yml", "configs/baselines/sta_mcnn.yml",
                     "configs/baselines/sta_sasnet.yml"]


def test_the_port_runs_59_of_59_configs():
    """23 until the whitening family was ported, then 41 (the 18
    configs/baselines/*_{sw,ibn,isw}.yml), 47 with the regressors (dgnet in
    modes simple and discrimination, reg_mem in mode regression), 58 with
    the generator (modes generation and joint) and the seven classic
    baseline configs (csrnet, mcnn, sasnet, dssinet, cctrans, and bl with
    the Bayesian loss on bay / jhu_domain_bay), 59 with the spatial mesh
    (configs/tpu/sta_final_spatial.yml)."""
    paths = sorted((REPO / "configs").rglob("*.yml"))
    ported = [str(p.relative_to(REPO)) for p in paths if _runs_in_the_port(p)]
    assert len(paths) == 59
    assert len(ported) == 59, ported
    assert set(REGRESSOR_CONFIGS) <= set(ported)
    assert set(GENERATOR_CONFIGS) <= set(ported)
    assert set(CLASSIC_BASELINES) <= set(ported)
    assert len(WHITENING_BASELINES) == 18
    assert set(WHITENING_BASELINES) <= set(ported)
    assert "configs/tpu/sta_final_bigcrop.yml" in ported
    assert "configs/tpu/sta_final_spatial.yml" in ported  # mesh: spatial
    assert sum(p.startswith("configs/ablation/") for p in ported) == 14


def test_generator_and_baselines_default_to_cuda_and_raise_without_it(tmp_path):
    """The generator's modes in the trainer, and the classic baselines in
    serving and in the trainer, never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is absent")
    from dgvcc_tpu_torch.core.config import Config
    from dgvcc_tpu_torch.serve import VideoCounter
    from dgvcc_tpu_torch.train.trainer import DGTrainer

    cfg = {"device": "tpu", "log_dir": str(tmp_path / "logs")}
    for name in ("csrnet", "mcnn", "bl", "sasnet", "dssinet", "cctrans"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            VideoCounter.from_checkpoint(name, None)
    for mode, name in (("generation", "gen"), ("joint", "dgnet"), ("simple", "bl")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DGTrainer(Config.from_dict(dict(cfg, mode=mode, model={"name": name})))
