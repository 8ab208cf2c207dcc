"""The port's config system (``utils/config.py``) and its JSON tree against
the JAX package's YAML system.

- Every JSON file under ``latent_diffusion_planning_tpu_torch/conf`` is
  ``yaml.safe_load`` of its YAML, and the tree holds every YAML file the
  Lift, Can and Square recipes compose.
- ``load_config`` equals the JAX ``load_config`` on every command line of
  ``tools/run_lift_pipeline.sh``, ``run_lift_baselines.sh``,
  ``run_lift_mixed_study.sh``, ``run_can_pipeline.sh`` and
  ``run_square_pipeline.sh`` (read off the scripts by running them in a
  scratch copy with a ``python`` that records its arguments), on the port's
  own recipe scripts (the same stages with ``.npz`` files), on a case of
  each override form, and on a run's resolved ``config.json``.
- Each ``configs.py`` recipe equals the port's ``load_config`` of its
  script's overrides, as ``tests/test_torch_configs.py`` holds it against
  the JAX system.
- ``instantiate`` maps the JAX tree's targets onto the port's callables and
  refuses one the port lacks.
"""

import json
import math
import os
import shutil
import subprocess
from pathlib import Path

import pytest
import yaml

from latent_diffusion_planning_tpu.utils import config as jcfg
from latent_diffusion_planning_tpu_torch import configs
from latent_diffusion_planning_tpu_torch.utils import config as pcfg

REPO = Path(__file__).resolve().parent.parent
YAML_ROOT = REPO / "latent_diffusion_planning_tpu" / "configs"
JSON_ROOT = REPO / "latent_diffusion_planning_tpu_torch" / "conf"
JSON_TREE = sorted(
    ["collect_data", "collect_demos", "eval_bc", "process_latents",
     "train_bc", "train_mixed_bc", "train_mixed_bc_actionfree", "train_vae",
     "agent/ldp_agent", "agent/ldp_hier_agent", "agent/dp_agent",
     "agent/dp_repr_agent", "model/stable_vae"]
    + [f"data/{task}/{name}" for task in ("lift", "can", "square")
       for name in ("img", "latent_img", "mixed_img", "mixed_latent_img")]
    + [f"data/aloha_cube/{name}" for name in (
        "wrist", "latent_wrist", "latent_wrist256", "mixed_wrist",
        "mixed_latent_wrist")]
    + [f"data/aloha_insertion/{name}" for name in (
        "latent_wrist", "latent_wrist256")])


@pytest.mark.parametrize("name", JSON_TREE)
def test_json_file_is_its_yaml(name):
    want = yaml.safe_load((YAML_ROOT / f"{name}.yaml").read_text())
    assert json.loads((JSON_ROOT / f"{name}.json").read_text()) == want


def test_json_tree_holds_the_lift_files_only():
    """The tree holds the files the recipes compose and nothing else: the
    Lift recipes' and the Can, Square and ALOHA data groups (the name
    predates them)."""
    got = sorted(p.relative_to(JSON_ROOT).with_suffix("").as_posix()
                 for p in JSON_ROOT.rglob("*") if p.is_file())
    assert got == JSON_TREE


def _command_lines(script: str, tmp: Path, env=None) -> list[list[str]]:
    """Every ``python tools/<x>.py ...`` command line ``script`` runs, read
    off a run in a scratch copy (``tmp``) whose ``python`` records its
    arguments and does nothing else; ``python -`` (an inline report) is
    left out."""
    (tmp / "tools").mkdir(parents=True)
    shutil.copy(REPO / "tools" / script, tmp / "tools" / script)
    (tmp / "bin").mkdir()
    shim = tmp / "bin" / "python"
    # one write a line: the port's study starts its arms at once
    shim.write_text('#!/bin/bash\n[ "$1" = "-" ] && { cat > /dev/null; '
                    'exit 0; }\nline=$(printf "%s\\037" "$@")\n'
                    'printf "%s\\n" "$line" >> "$CMDS"\n')
    shim.chmod(0o755)
    cmds = tmp / "cmds.txt"
    run_env = {**os.environ, "PATH": f"{tmp / 'bin'}:{os.environ['PATH']}",
               "CMDS": str(cmds), **(env or {})}
    # the JAX pipeline script ends by copying a run into assets/, which the
    # scratch copy does not have: it stops there, after its stages
    subprocess.run(["bash", str(tmp / "tools" / script)], env=run_env,
                   cwd=tmp, capture_output=True, timeout=60)
    lines = [line.split("\x1f")[:-1]
             for line in cmds.read_text().splitlines()]
    return [line for line in lines if not line[0].endswith("snapshot_run.py")]


def _by_run_name(lines):
    """``lines`` with the runs (``experiment_name=``) in the order of their
    names after the other stages, which keep their order: the port's study
    starts its arms at once, so they record in any order."""
    def name(line):
        return next((arg.split("=", 1)[1] for arg in line
                     if arg.startswith("experiment_name=")), "")
    return sorted(lines, key=name)


def _driver(line) -> str:
    return Path(line[0]).stem.removesuffix("_torch")


def _both(line):
    name, overrides = pcfg.parse_cli(line[1:])
    name = name or _driver(line)
    return (jcfg.load_config(name, overrides).to_dict(),
            pcfg.load_config(name, overrides).to_dict())


JAX_SCRIPTS = {
    "run_lift_pipeline.sh": ({"RUN": "pipeline3"}, [
        "collect_demos", "collect_demos", "train_vae", "process_latents",
        "train_bc"]),
    "run_lift_baselines.sh": ({}, ["train_bc"] * 3),
    "run_lift_mixed_study.sh": ({"STEPS": "20000"}, [
        "collect_data", "process_latents", "train_bc", "train_mixed_bc",
        "train_mixed_bc"]),
    "run_can_pipeline.sh": ({}, [
        "collect_demos", "collect_demos", "train_vae", "process_latents",
        "train_bc"]),
    "run_square_pipeline.sh": ({}, [
        "collect_demos", "collect_demos", "train_vae", "process_latents",
        "train_bc"]),
}


@pytest.mark.parametrize("script", list(JAX_SCRIPTS))
def test_load_config_matches_jax_on_every_recipe_line(script, tmp_path):
    env, drivers = JAX_SCRIPTS[script]
    lines = _command_lines(script, tmp_path, env)
    assert [_driver(line) for line in lines] == drivers
    for line in lines:
        want, got = _both(line)
        assert got == want, line


# the port's scripts against the JAX ones: the same stages, the same
# configs once the port's .npz files read as the JAX .hdf5 ones
PORT_SCRIPTS = {
    "run_lift_pipeline_torch.sh": ("run_lift_pipeline.sh",
                                   {"RUN": "pipeline3"}),
    "run_lift_mixed_study_torch.sh": ("run_lift_mixed_study.sh",
                                      {"RUN": "mixed_study",
                                       "STEPS": "20000"}),
    "run_can_pipeline_torch.sh": ("run_can_pipeline.sh", {}),
    "run_square_pipeline_torch.sh": ("run_square_pipeline.sh", {}),
}


def _as_jax_files(tree):
    """The port's file names as the JAX scripts' (``.hdf5`` files; the
    study reads the pipeline run ``pipeline3``)."""
    if isinstance(tree, dict):
        return {k: _as_jax_files(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_jax_files(v) for v in tree]
    if isinstance(tree, str):
        tree = tree.replace("experiments/pipeline_torch/",
                            "experiments/pipeline3/")
        if tree.endswith(".npz"):
            return tree[:-len(".npz")] + ".hdf5"
    return tree


@pytest.mark.parametrize("script", list(PORT_SCRIPTS))
def test_port_recipe_scripts_make_the_jax_stages(script, tmp_path):
    """Each stage of the port's script loads (through the port) the config
    its JAX script's stage loads (through JAX), up to the file suffix; the
    port's script writes nothing under ``assets/``."""
    jax_script, env = PORT_SCRIPTS[script]
    got_lines = _by_run_name(_command_lines(script, tmp_path / "port", env))
    want_lines = _by_run_name(_command_lines(jax_script, tmp_path / "jax",
                                             env))
    assert [_driver(line) for line in got_lines] == [
        _driver(line) for line in want_lines]
    for got_line, want_line in zip(got_lines, want_lines):
        name, overrides = pcfg.parse_cli(got_line[1:])
        got = pcfg.load_config(name or _driver(got_line), overrides)
        want = _both(want_line)[0]
        assert _as_jax_files(got.to_dict()) == want, got_line
    assert not (tmp_path / "port" / "assets").exists()
    assert not [line for line in (REPO / "tools" / script).read_text()
                .splitlines()
                if "assets" in line and not line.lstrip().startswith("#")]


# a case of each override form: values read as YAML would read them, group
# swaps, additions, nested keys, lists with nulls, interpolation after it
VALUES = ["null", "~", "true", "False", "on", "off", "3e-4", "1.0e-4", "42",
          "-5", "+3", "0.5", "010", "0x1f", "1_000", ".inf", "[64,128,256]",
          "[8,null]", "[a, [b, c], {d: e}]", "{a: 1, b: [2, 3]}", "[]", "{}",
          "'quoted'", "'3'", '"x\\ty"', "abc/def.npz", "hello world", "a #c",
          "", "${eval:'1+2'}", "experiments/x/ckpt/4000.ckpt"]


@pytest.mark.parametrize("text", VALUES)
def test_override_values_read_as_jax_reads_them(text):
    want, got = jcfg._parse_value(text), pcfg._parse_value(text)
    if isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert got == want and type(got) is type(want)


OVERRIDE_FORMS = [
    ("train_bc", ["agent=ldp_hier_agent"]),                    # group swap
    ("train_bc", ["data=lift/latent_img", "horizon=9"]),       # interpolation
    ("train_bc", ["+extra.nested.key=7", "+top=x"]),           # additions
    ("train_bc", ["agent.planner.down_dims=[8,16]", "lr=1e-3"]),
    ("train_mixed_bc", ["mixed_data.train_n_episode_overfit=[2,null]"]),
    ("train_mixed_bc_actionfree", []),
    ("train_vae", ["model.vae.patch_size=4", "data=lift/mixed_img"]),
    ("eval_bc", ["run_dir=x", "ckpt_steps=[100,300]", "plan_blend=0.5"]),
]


@pytest.mark.parametrize("name,overrides", OVERRIDE_FORMS)
def test_override_forms_match_jax(name, overrides):
    assert (pcfg.load_config(name, overrides).to_dict()
            == jcfg.load_config(name, overrides).to_dict())


def test_a_runs_config_json_loads_back(tmp_path):
    cfg = pcfg.load_config("train_bc", ["agent=ldp_agent",
                                        "data=lift/latent_img"])
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    assert pcfg.load_config(str(tmp_path / "config.json")) == cfg
    assert pcfg.load_config(str(tmp_path / "config.json"),
                            ["lr=0.5"]).lr == 0.5
    with pytest.raises(pcfg.ConfigError, match="JSON"):
        pcfg.load_config(str(tmp_path / "config.yaml"))
    with pytest.raises(pcfg.ConfigError, match="available"):
        pcfg.load_config("train_bc", ["agent=nope"])
    with pytest.raises(pcfg.ConfigError, match="unrecognized"):
        pcfg.parse_cli(["--config", "train_bc", "stray"])
    assert pcfg.parse_cli(["-c", "x", "a=1"]) == ("x", ["a=1"])


def _plain(tree):
    """A resolved config as ``configs.py`` writes it: no ``_target_``,
    ``_defer_`` or ``_groups_`` (an env's target becomes its ``name``, a
    ``MixedOfflineData`` section gains ``"mixed": true``)."""
    if isinstance(tree, dict):
        out = {k: _plain(v) for k, v in tree.items()
               if k not in ("_target_", "_defer_", "_groups_")}
        target = str(tree.get("_target_", ""))
        if target.endswith("Env"):
            out["name"] = target.rsplit(".", 1)[1]
        if target.endswith("MixedOfflineData"):
            out["mixed"] = True
        return out
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    return tree


def _holds(recipe: dict, loaded: dict, skip=("fused_dtype",)):
    """Every key of a ``configs.py`` recipe equals the loaded config's (the
    recipe may leave out keys the port does not read; ``fused_dtype`` is
    the port's own)."""
    for k, v in recipe.items():
        if k in skip:
            continue
        assert k in loaded, k
        if isinstance(v, dict) and isinstance(loaded[k], dict):
            _holds(v, loaded[k], skip)
        else:
            assert v == loaded[k], k


def _stage(lines, driver, index=0):
    line = [ln for ln in lines if _driver(ln) == driver][index]
    name, overrides = pcfg.parse_cli(line[1:])
    return _plain(pcfg.load_config(name or driver, overrides).to_dict())


def test_configs_recipes_equal_load_config_of_their_scripts(tmp_path):
    pipe = _command_lines("run_lift_pipeline.sh", tmp_path / "p",
                          {"RUN": "pipeline3"})
    base = _command_lines("run_lift_baselines.sh", tmp_path / "b")
    hier = _command_lines("run_lift_baselines.sh", tmp_path / "h",
                          {"STEPS": "15000"})
    study = _command_lines("run_lift_mixed_study.sh", tmp_path / "s")
    _holds(configs.lift_vae_train_config(), _stage(pipe, "train_vae"))
    bench = configs.bench_train_config(
        "experiments/pipeline3/vae/ckpt/4000.ckpt")
    bench["agent"].update(planner_inference_steps=25, idm_inference_steps=25)
    _holds(bench, _stage(pipe, "train_bc"))
    _holds(configs.lift_dp_train_config(), _stage(base, "train_bc", 0))
    _holds(configs.lift_dp_vae_train_config(), _stage(base, "train_bc", 1))
    _holds(configs.lift_ldp_hier_train_config(), _stage(hier, "train_bc", 2))
    vae = "experiments/pipeline3/vae/ckpt/4000.ckpt"
    for arm, (driver, i) in {"expert": ("train_bc", 0),
                             "mixed": ("train_mixed_bc", 0),
                             "actionfree": ("train_mixed_bc", 1)}.items():
        _holds(configs.lift_mixed_study_config(arm, 8, vae),
               _stage(study, driver, i))
    _holds(configs.lift_collect_data_config(), _stage(study, "collect_data"))


def test_instantiate_maps_targets_onto_the_port(tmp_path):
    from latent_diffusion_planning_tpu_torch.envs.lift import LiftEnv
    from latent_diffusion_planning_tpu_torch.envs.lift_physics import (
        LiftPhysicsEnv)
    cfg = pcfg.load_config("collect_demos")
    env = pcfg.instantiate(cfg.env)
    assert type(env) is LiftPhysicsEnv and env.episode_len == 80
    kin = pcfg.instantiate({**cfg.env, "_target_":
                            "latent_diffusion_planning_tpu.envs.lift.LiftEnv"},
                           episode_len=7)
    assert type(kin) is LiftEnv and kin.episode_len == 7
    make = pcfg.instantiate({**cfg.env, "_partial_": True})
    assert make(episode_len=5).episode_len == 5
    agent_cfg = pcfg.load_config("train_bc", ["agent=ldp_agent"]).agent
    deferred = pcfg.instantiate(agent_cfg.planner)
    assert deferred["_target_"].endswith("ConditionalUnet1D")
    assert "_defer_" not in deferred
    with pytest.raises(pcfg.ConfigError, match="not ported"):
        pcfg.instantiate({"_target_": "latent_diffusion_planning_tpu.envs."
                          "aloha_cube.AlohaCubeEnv"})
    with pytest.raises(pcfg.ConfigError, match="not ported"):
        pcfg.instantiate({"_target_": "os.system", "command": "true"})


def test_instantiate_builds_a_port_agent():
    """An agent target is the port's factory, taking the node as its config
    mapping: the same agent ``LDPAgent.create`` builds from the same dict."""
    import torch
    from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent
    cfg = pcfg.load_config("train_bc", [
        "agent=ldp_agent", "data=lift/latent_img",
        "model_vae.block_out_channels=[8,8,8,8]", "model_vae.patch_size=4",
        "model_vae.norm_groups=4", "agent.planner.down_dims=[16,32]",
        "agent.idm_net.hidden_dim=32"])
    agent = pcfg.instantiate(cfg.agent, configs.SHAPE_META, seed=3,
                             device="cpu")
    same = LDPAgent.create(dict(cfg.agent), configs.SHAPE_META, seed=3,
                           device="cpu")
    assert type(agent) is LDPAgent
    for (k, v), w in zip(agent.get_params()["planner_params"].items(),
                         same.get_params()["planner_params"].values()):
        assert torch.equal(v, w), k


# ---------------------------------------------------------------------------
# ALOHA: the registries, the phys4 recipe and its agent
# ---------------------------------------------------------------------------

ALOHA_NAMES = {
    "sim_transfer_cube": "AlohaTransferCubeEnv",
    "sim_transfer_cube_scripted": "AlohaTransferCubeEnv",
    "sim_transfer_cube_human": "AlohaTransferCubeEnv",
    "sim_insertion": "AlohaInsertionEnv",
    "sim_insertion_scripted": "AlohaInsertionEnv",
    "sim_insertion_human": "AlohaInsertionEnv",
    "AlohaTransferCubeEnv": "AlohaTransferCubeEnv",
    "AlohaInsertionEnv": "AlohaInsertionEnv",
}


@pytest.mark.parametrize("name", list(ALOHA_NAMES))
def test_aloha_names_resolve_through_make_env_from_meta(name):
    """The eight names the JAX package registers build the port's env (the
    robosuite-style names honour ``camera_heights`` and ``horizon``), as
    the JAX ``make_env_from_meta`` builds its own."""
    from latent_diffusion_planning_tpu.envs.from_meta import (
        make_env_from_meta as jax_make)
    from latent_diffusion_planning_tpu_torch.envs.from_meta import (
        make_env_from_meta)
    native = name.startswith("Aloha")
    kwargs = ({"image_size": 32, "episode_len": 150} if native else
              {"camera_heights": 32, "camera_widths": 32, "horizon": 150,
               "camera_names": ["wrist64"]})
    meta = {"env_name": name, "env_kwargs": kwargs}
    env = make_env_from_meta(meta, render_images=False)
    want = jax_make(meta, render_images=False)
    assert type(env).__name__ == type(want).__name__ == ALOHA_NAMES[name]
    assert (env.image_size, env.episode_len) == (32, 150)
    assert (want.image_size, want.episode_len) == (32, 150)
    assert env.obs_keys == want.obs_keys and env.action_dim == 14


def test_aloha_targets_instantiate_the_port_envs():
    from latent_diffusion_planning_tpu_torch.envs.aloha_cube import (
        AlohaTransferCubeEnv)
    from latent_diffusion_planning_tpu_torch.envs.aloha_insertion import (
        AlohaInsertionEnv)
    for task, cls in (("aloha_cube", AlohaTransferCubeEnv),
                      ("aloha_insertion", AlohaInsertionEnv)):
        cfg = pcfg.load_config("train_bc", [f"data={task}/latent_wrist256"])
        env = pcfg.instantiate(cfg.data.env_params.env, mesh_mode="kdop")
        assert type(env) is cls and env.episode_len == 400
        assert env.n_convex == 18


def test_port_aloha_recipe_makes_the_jax_stages(tmp_path):
    """``tools/run_aloha_phys4_torch.sh`` runs the JAX recipe's stages
    (``tools/run_aloha_phys4.sh`` without its TPU streamed-sampler smoke):
    each loads, through the port, the config the JAX stage loads through
    JAX, up to the file suffix. A ``git`` on PATH that does nothing keeps
    the JAX script's commit of its smoke log inside the scratch copy."""
    (tmp_path / "git").mkdir()
    git = tmp_path / "git" / "git"
    git.write_text("#!/bin/bash\nexit 0\n")
    git.chmod(0o755)
    env = lambda sub: {"STEPS": "20000", "PATH": f"{tmp_path / sub / 'bin'}:"
                       f"{tmp_path / 'git'}:{os.environ['PATH']}"}
    got_lines = _command_lines("run_aloha_phys4_torch.sh", tmp_path / "port",
                               env("port"))
    want_lines = [line for line in _command_lines(
        "run_aloha_phys4.sh", tmp_path / "jax", env("jax"))
        if _driver(line) != "smoke_streamed_sampler"]
    assert [_driver(line) for line in got_lines] == [
        _driver(line) for line in want_lines] == [
        "collect_demos"] * 4 + ["train_vae", "process_latents", "train_bc"]
    for got_line, want_line in zip(got_lines, want_lines):
        name, overrides = pcfg.parse_cli(got_line[1:])
        got = pcfg.load_config(name or _driver(got_line), overrides)
        want = _both(want_line)[0]
        assert _as_jax_files(got.to_dict()) == want, got_line
    assert not (tmp_path / "port" / "assets").exists()


def _phys4_agent_config(tmp):
    """The phys4 recipe's train_bc stage, read off the port's script and
    loaded through the port: (agent config, shape meta)."""
    line = next(ln for ln in _command_lines("run_aloha_phys4_torch.sh", tmp)
                if _driver(ln) == "train_bc")
    name, overrides = pcfg.parse_cli(line[1:])
    cfg = pcfg.load_config(name or "train_bc", overrides)
    agent_cfg = dict(cfg.agent)
    agent_cfg.pop("vae_pretrain_path")
    agent_cfg["obs_normalization"] = cfg.data.meta.obs_normalization
    return agent_cfg, cfg.data.meta.shape_meta


def test_ldp_agent_builds_the_phys4_agent(tmp_path):
    """At the recipe's widths: the planner predicts x0 over 270-wide
    latents-plus-qpos with down_dims [128,256,512], the IDM conditions on
    two observations (S = 540) for 14 actions; both pass the kernels'
    check, and kernel A's launch fits at 32 rows a block."""
    import torch
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_mlp as kmlp)
    from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent
    agent_cfg, meta = _phys4_agent_config(tmp_path)
    agent = LDPAgent.create(agent_cfg, meta, device="cpu")
    assert agent.planner_sched.prediction_type == "sample"
    assert agent.idm_sched.prediction_type == "epsilon"
    assert agent.config.obs_dim == 270 and agent.config.action_dim == 14
    assert agent.idm.s_dim == 540 and agent.idm.out_dim == 14
    agent._check_kernels()
    info = kmlp.kernel_info(agent.idm, 256, 14, 540, 25)
    assert info["rows_per_block"] == 32 and info["smem_bytes"] <= (
        kmlp.SMEM_LIMIT)
    ts, coefs = agent._table(agent.planner_sched,
                             agent.config.planner_inference_steps)
    assert coefs.shape == (25, 6)
    assert torch.equal(coefs[:, 5], torch.zeros(25))
