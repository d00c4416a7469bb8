"""The port's observability on the CPU: loggers, the profiler, the watchdog.

The trainer runs with `device="cpu"` and my_vit_mini at 32 px (10
classes) cut to 2 blocks, 2 epochs of 2 steps (the profile cases 3 and 5
steps) and 1 eval batch. `log.txt` is held to the one the JAX trainer
writes for the same config (its model cut the same way). The TensorBoard
case needs tensorboard, which is installed here; the wandb case makes
wandb fail to import, as on a machine without it.
"""
import json
import logging
import os
import sys
import time

import pytest

from vision_transformers_torch_xla_tpu_torch.core.config import TrainConfig
from vision_transformers_torch_xla_tpu_torch.launch import main as trainer
from vision_transformers_torch_xla_tpu_torch.obs import loggers, profiler
from vision_transformers_torch_xla_tpu_torch.obs.watchdog import StepWatchdog

DEPTH = 2


def _cfg(out, **kw):
    base = dict(model="my_vit_mini", input_size=32, nb_classes=10,
                data_set="synthetic", batch_size=4, epochs=2,
                limit_steps_per_epoch=2, limit_eval_batches=1,
                warmup_epochs=0, lr=1e-3, device="cpu", log_freq=1,
                synthetic_train_size=64, synthetic_val_size=32,
                output_dir=str(out), save_ckpt=False)
    base.update(kw)
    return TrainConfig(**base)


@pytest.fixture
def shallow(monkeypatch):
    """The trainer's models cut to DEPTH blocks."""
    create = trainer.create_model
    monkeypatch.setattr(trainer, "create_model",
                        lambda name, **kw: create(name, depth=DEPTH, **kw))


# ---- the loggers --------------------------------------------------------------

def test_log_txt_has_the_jax_trainers_lines(tmp_path, shallow, monkeypatch):
    from vision_transformers_torch_xla_tpu.core.config import (
        TrainConfig as JaxConfig,
    )
    from vision_transformers_torch_xla_tpu.launch import main as jax_trainer

    stats = trainer.main(_cfg(tmp_path / "port"))
    jcreate = jax_trainer.create_model
    monkeypatch.setattr(jax_trainer, "create_model",
                        lambda name, **kw: jcreate(name, depth=DEPTH, **kw))
    kw = {k: v for k, v in vars(_cfg(tmp_path / "jax")).items()}
    jax_trainer.main(JaxConfig(**{**kw, "mesh_shape": "data:1"}))
    got = [json.loads(l) for l in open(tmp_path / "port" / "log.txt")]
    want = [json.loads(l) for l in open(tmp_path / "jax" / "log.txt")]
    assert len(got) == len(want) == 2
    assert [r["epoch"] for r in got] == [0, 1]
    assert [set(r) for r in got] == [set(r) for r in want]
    assert got[-1] == stats


def test_tensorboard_writes_event_files_under_log_dir(tmp_path, shallow):
    trainer.main(_cfg(tmp_path / "out", enable_tensorboard=True,
                      log_dir=str(tmp_path / "tb")))
    events = [n for n in os.listdir(tmp_path / "tb")
              if n.startswith("events.out.tfevents")]
    assert events
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    # log_freq 1: every step of both epochs, numbered epoch·steps + i
    assert {"train/loss", "train/lr", "train/grad_norm"} <= \
        set(acc.Tags()["scalars"])
    assert [e.step for e in acc.Scalars("train/loss")] == [0, 1, 2, 3]


def test_wandb_absent_warns_and_the_run_completes(tmp_path, shallow, caplog,
                                                 monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb fails
    with caplog.at_level(logging.WARNING):
        stats = trainer.main(_cfg(tmp_path, enable_wandb=True))
    assert stats["epoch"] == 1
    assert "wandb unavailable" in caplog.text


def test_jsonl_logger_appends_and_skips_without_a_dir(tmp_path):
    jl = loggers.JsonlLogger(str(tmp_path / "o"))
    jl.log({"epoch": 0, "acc": 1.0})
    jl.log({"epoch": 1, "acc": 2.0})
    recs = [json.loads(l) for l in open(tmp_path / "o" / "log.txt")]
    assert [r["epoch"] for r in recs] == [0, 1]
    loggers.JsonlLogger("").log({"epoch": 0})  # no output_dir: nothing


def test_event_logger_writes_tagged_file(tmp_path):
    ev = loggers.EventLogger("dataset", log_dir=str(tmp_path))
    ev.log("built train split")
    ev.log("built val split")
    lines = open(tmp_path / "dataset.log").readlines()
    assert len(lines) == 2
    assert "[dataset]" in lines[0] and "train split" in lines[0]


def test_build_loggers_takes_the_sinks_the_config_asks_for(tmp_path):
    cfg = _cfg(tmp_path)
    assert set(loggers.build_loggers(cfg)) == {"jsonl"}
    # tensorboard needs --log_dir, as in JAX
    assert set(loggers.build_loggers(_cfg(tmp_path, enable_tensorboard=True))
               ) == {"jsonl"}
    assert loggers.is_main_process()


# ---- the profiler ------------------------------------------------------------

@pytest.mark.parametrize("steps", [5, 3], ids=["window-closes", "epoch-ends"])
def test_profile_steps_write_one_trace(tmp_path, shallow, steps, capsys):
    """--profile_steps 2: steps 2 and 3 of the first epoch; with 3 steps
    the epoch ends inside the window and closes it."""
    trainer.main(_cfg(tmp_path, profile_steps=2, epochs=1,
                      limit_steps_per_epoch=steps))
    out = tmp_path / "profile"
    traces = os.listdir(out)
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    with open(out / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert capsys.readouterr().out.count("profile trace written to") == 1


def test_trace_writes_the_named_regions(tmp_path):
    import torch

    with profiler.trace(str(tmp_path / "p")):
        with profiler.named_scope("scope"), \
                profiler.step_annotation("train", 3):
            torch.ones(4).sum()
    (name,) = os.listdir(tmp_path / "p")
    with open(tmp_path / "p" / name) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"scope", "train#3"} <= names


def test_step_timer_percentiles():
    t = profiler.StepTimer()
    for _ in range(5):
        t.start()
        time.sleep(0.01)
        t.stop()
    s = t.summary()
    assert s["n"] == 5
    assert 0.005 < s["p50_s"] < 0.5


# ---- the watchdog ------------------------------------------------------------

def test_watchdog_fires_once_per_stall_and_not_while_beating():
    stalls = []
    wd = StepWatchdog(timeout_s=0.2,
                      on_stall=lambda age, steps: stalls.append(steps))
    wd.start()
    try:
        time.sleep(1.0)  # no beat: one stall, reported once
        assert stalls == [0]
        for _ in range(25):  # beats every 0.02 s: no stall
            wd.beat()
            time.sleep(0.02)
        assert stalls == [0]
    finally:
        wd.stop()
    assert not wd._thread.is_alive()


def test_main_beats_the_watchdog_each_step(tmp_path, shallow, monkeypatch):
    made = []

    class Recording(StepWatchdog):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.beats, self.stopped = 0, False
            made.append(self)

        def beat(self):
            self.beats += 1
            super().beat()

        def stop(self):
            self.stopped = True
            super().stop()

    monkeypatch.setattr(trainer, "StepWatchdog", Recording)
    trainer.main(_cfg(tmp_path))
    (wd,) = made
    assert wd.timeout_s == 900.0 and wd.beats == 4 and wd.stopped
