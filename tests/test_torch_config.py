"""Port parity of the config tree (dicttts_tpu_torch.config and
dicttts_tpu_torch/configs/) against dicttts_tpu.config and its YAML files:
the recipe resolves to the same dict key for key (task_cls apart, which
names the port's task; the HiFi-GAN configs too), override strings coerce alike, the saved
config.yaml is read back as the JAX package reads it, and run.py names
the tasks the port lacks. The PortaSpeech and FastSpeech2 trees
(tts/ps_adv.yaml, tts/ps_flow.yaml, tts/fs2.yaml,
datasets/biaobei/{base_text2mel,ps_adv,ps_flow,fs2}.yaml) equal the JAX
trees but for task_cls, which names the port's task of the same module
path (dicttts_tpu_torch. for dicttts_tpu.); so does tts/base.yaml, whose
task is FastSpeech2's."""

import os

import pytest
import yaml

from dicttts_tpu import config as jconfig
from dicttts_tpu_torch import config as tconfig
from dicttts_tpu_torch.run import task_class
from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask
from dicttts_tpu_torch.train.tasks.fs2 import FastSpeech2Task
from dicttts_tpu_torch.train.tasks.hifigan import HifiGanTask
from dicttts_tpu_torch.train.tasks.ps_adv import PortaSpeechAdvTask
from dicttts_tpu_torch.train.tasks.ps_flow import PortaSpeechFlowTask

ROOT = os.path.join(os.path.dirname(__file__), "..")
FILES = ["base.yaml", "tts/base.yaml", "tts/ps_flow.yaml", "tts/ps_adv.yaml", "tts/dict_tts.yaml",
         "datasets/biaobei/dict_tts.yaml", "tts/hifigan.yaml", "datasets/biaobei/hifigan.yaml",
         "datasets/wenetspeech/hifigan.yaml", "datasets/biaobei/base_text2mel.yaml",
         "datasets/biaobei/ps_adv.yaml", "datasets/biaobei/ps_flow.yaml", "tts/fs2.yaml",
         "datasets/biaobei/fs2.yaml"]
PORT_TASK = "dicttts_tpu_torch.train.tasks.dict_tts.DictTTSTask"
PORT_VOCODER_TASK = "dicttts_tpu_torch.train.tasks.hifigan.HifiGanTask"
PORT_PS_TASKS = {"ps_adv.yaml": "dicttts_tpu_torch.train.tasks.ps_adv.PortaSpeechAdvTask",
                 "ps_flow.yaml": "dicttts_tpu_torch.train.tasks.ps_flow.PortaSpeechFlowTask"}
PORT_FS2_TASK = "dicttts_tpu_torch.train.tasks.fs2.FastSpeech2Task"


def _port_task(name):
    """The task_cls a port config names in place of the JAX task, or None."""
    if name.endswith("dict_tts.yaml"):
        return PORT_TASK
    if name.endswith("hifigan.yaml"):
        return PORT_VOCODER_TASK
    if name == "tts/base.yaml" or name.endswith("fs2.yaml"):
        return PORT_FS2_TASK
    return PORT_PS_TASKS.get(os.path.basename(name))


def _pair(name):
    return (os.path.join(ROOT, "dicttts_tpu", "configs", name),
            os.path.join(tconfig.CONFIG_ROOT, name))


@pytest.mark.parametrize("name", FILES)
def test_config_tree_resolves_as_the_jax_tree(name):
    jax_path, port_path = _pair(name)
    want = jconfig.load_config(jax_path, save=False)
    got = tconfig.load_config(port_path, save=False)
    assert set(got) == set(want)
    for key in want:
        if key == "task_cls" and _port_task(name):
            assert got[key] == _port_task(name)
        else:
            assert got[key] == want[key], key
            assert type(got[key]) is type(want[key]), key


@pytest.mark.parametrize("name", FILES)
def test_each_port_file_holds_the_jax_values(name):
    jax_path, port_path = _pair(name)
    with open(jax_path) as f:
        want = yaml.safe_load(f)
    with open(port_path) as f:
        got = yaml.safe_load(f)
    if "task_cls" in want and _port_task(name):
        want["task_cls"] = _port_task(name)
    assert got == want


@pytest.mark.parametrize("overrides", [
    "max_updates=12,val_check_interval=6",
    "discriminator_optimizer_params.eps=1e-5,discriminator_scheduler_params.gamma=0.25",
    "mel_buckets=[256 512],txt_buckets=[64]",
    "amp=True,use_device_frame_cache=False,save_best=False",
    "lr=0.5,binary_data_dir=/data/bin,new_key=7,new_list=[1 2 3],new_name=abc",
    "mel_loss='l1:1.0',vocoder_ckpt=ckpt/hifi",
    "brand.new.nested=1.5",
])
def test_override_strings_coerce_as_the_jax_package(overrides):
    jax_path, port_path = _pair("datasets/biaobei/dict_tts.yaml")
    want = jconfig.parse_override_string(overrides, jconfig.load_config(jax_path, save=False))
    got = tconfig.parse_override_string(overrides, tconfig.load_config(port_path, save=False))
    want["task_cls"] = PORT_TASK
    assert got == want
    assert {k: type(v) for k, v in got.items()} == {k: type(v) for k, v in want.items()}


def test_saved_config_is_read_back_unless_reset(tmp_path):
    _, port_path = _pair("datasets/biaobei/dict_tts.yaml")
    root = str(tmp_path)
    first = tconfig.load_config(port_path, "exp", "max_updates=12", checkpoints_root=root)
    saved = os.path.join(root, "exp", "config.yaml")
    assert first["work_dir"] == os.path.join(root, "exp") and os.path.exists(saved)
    with open(saved) as f:  # the JAX package reads the port's saved config
        assert yaml.safe_load(f) == {k: v for k, v in first.items() if k not in ("exp_name", "infer")}
    again = tconfig.load_config(port_path, "exp", checkpoints_root=root)
    assert again["max_updates"] == 12  # the saved value wins over the YAML tree
    reset = tconfig.load_config(port_path, "exp", reset=True, checkpoints_root=root)
    assert reset["max_updates"] == 300000
    assert jconfig.load_config(port_path, "exp", reset=True, checkpoints_root=root)["max_updates"] == 300000


def test_a_missing_config_file_raises(tmp_path):
    leaf = tmp_path / "leaf.yaml"
    leaf.write_text("base_config: ./missing.yaml\nlr: 2.0\n")
    with pytest.raises(FileNotFoundError):
        tconfig.load_config(str(leaf), save=False)


def test_config_view_is_immutable():
    cfg = tconfig.Config({"a": 1})
    assert cfg.a == 1 and cfg["a"] == 1 and "a" in cfg and cfg.get("b", 2) == 2
    with pytest.raises(AttributeError):
        cfg.a = 2
    assert cfg.replace(a=3).a == 3 and cfg.a == 1


@pytest.mark.parametrize("name", FILES[1:])
def test_run_names_the_tasks_not_ported(name):
    task_cls = tconfig.load_config(_pair(name)[1], save=False).get("task_cls")
    if name.endswith("base_text2mel.yaml"):
        assert task_cls is None  # a dataset fragment, with no task
    elif name.endswith("dict_tts.yaml"):
        assert task_class(task_cls) is DictTTSTask
    elif name.endswith("hifigan.yaml"):
        assert task_class(task_cls) is HifiGanTask
    elif _port_task(name) == PORT_FS2_TASK:
        assert task_class(task_cls) is FastSpeech2Task
    elif os.path.basename(name) in PORT_PS_TASKS:
        assert task_class(task_cls) is {"ps_adv.yaml": PortaSpeechAdvTask,
                                        "ps_flow.yaml": PortaSpeechFlowTask}[os.path.basename(name)]
    else:
        with pytest.raises(NotImplementedError, match=task_cls.replace(".", r"\.")):
            task_class(task_cls)
