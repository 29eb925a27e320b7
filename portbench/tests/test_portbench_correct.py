"""What decides `correct`, on the CPU at a tiny size: a sound run of each
cell, the faults each cell can have planted in the program underneath the
harness (whose look for a card is skipped), and the control, each of which
has to come out not correct against the cell's limits.  The control of the
float32 pretraining cell is TF32, which only the card has."""
from __future__ import annotations

import pytest
import torch

from tiny import run_cell, shrink

FAULTS = [("adapt-kitti-seq", "state_unchanged"), ("adapt-kitti-seq", "half_batch"),
          ("adapt-kitti-seq", "answer_altered"),
          ("adapt-kitti-covio-async", "state_unchanged"),
          ("adapt-kitti-covio-async", "half_batch"),
          ("adapt-kitti-covio-async", "answer_altered"),
          ("adapt-kitti-covio-async", "stale_served"),
          ("adapt-kitti-covio-async", "short_update"),
          ("pretrain-cityscapes-b18", "state_unchanged"),
          ("pretrain-cityscapes-b18", "half_batch"),
          ("pretrain-cityscapes-b18", "answer_altered")]


def plant(monkeypatch, cell: str, fault: str, active=lambda: True) -> None:
    """Break the program where the fault would be made, while `active()`."""
    import tpuslam_torch.slam.slam as sm
    import tpuslam_torch.train.pretrain as pm
    import tpuslam_torch.train.steps as st

    if fault == "stale_served":  # each frame served from the state before the last adopted
        adopt = sm.Slam._adopt

        def keep_old(self):
            self._stale_state = self.state
            adopt(self)

        def model(self):
            return (getattr(self, "_stale_state", self.state) if active() else self.state).model

        monkeypatch.setattr(sm.Slam, "_adopt", keep_old)
        monkeypatch.setattr(sm.Slam, "model", property(model))
    elif fault == "short_update":  # each update one iteration short
        launch = sm.consolidate_step_async

        def short(state, cfg, batch, num_steps, *args, **kwargs):
            return launch(state, cfg, batch, num_steps - 1 if active() else num_steps, *args,
                          **kwargs)

        monkeypatch.setattr(sm, "consolidate_step_async", short)
    elif fault == "state_unchanged":  # the optimizer step leaves the parameters as they are
        adam_step = torch.optim.Adam.step

        def still(self, closure=None):
            return None if active() else adam_step(self, closure)

        monkeypatch.setattr(torch.optim.Adam, "step", still)
    elif fault == "half_batch":  # half the rows left out, the mean over the rest
        total_loss = st.total_loss

        def halved(*args, sample_weights=None, **kwargs):
            if not active():
                return total_loss(*args, sample_weights=sample_weights, **kwargs)
            w = torch.zeros_like(sample_weights)
            half = max(1, w.shape[0] // 2)
            w[:half] = 1.0 / half
            return total_loss(*args, sample_weights=w, **kwargs)

        monkeypatch.setattr(st, "total_loss", halved)
    elif cell == "pretrain-cityscapes-b18":  # each step's loss altered where it is made
        train_step = pm.train_step

        def altered(state, cfg, batch):
            losses = train_step(state, cfg, batch)
            return dict(losses, loss=losses["loss"] * 1.1) if active() else losses

        monkeypatch.setattr(pm, "train_step", altered)
    else:  # each frame's pose altered where it is packed for the host
        pack = st._pack_retire

        def altered(losses, outputs):
            key = ("cam_T_cam", 0, 1)
            outputs = dict(outputs)
            outputs[key] = torch.linalg.inv(outputs[key])
            return pack(losses, outputs)

        monkeypatch.setattr(st, "_pack_retire", altered)


@pytest.mark.parametrize("cell", ["adapt-kitti-seq", "pretrain-cityscapes-b18",
                                  "adapt-kitti-covio-async"])
def test_sound_run_is_correct(monkeypatch, cell):
    shrink(monkeypatch)
    line, _ = run_cell(cell)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(monkeypatch, cell, fault):
    shrink(monkeypatch)
    plant(monkeypatch, cell, fault)
    line, _ = run_cell(cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_window_fault_is_not_correct(monkeypatch, fault):
    """A fault in the pretraining window's steps alone, the set-up epoch
    sound: the window's own numbers fail."""
    import tpuslam_torch.train.pretrain as pm

    shrink(monkeypatch)
    epochs = []
    train_epoch = pm.Pretrainer.train_epoch

    def counted(self, *args, **kwargs):
        epochs.append(1)
        return train_epoch(self, *args, **kwargs)

    monkeypatch.setattr(pm.Pretrainer, "train_epoch", counted)
    plant(monkeypatch, "pretrain-cityscapes-b18", fault, active=lambda: len(epochs) > 1)
    line, _ = run_cell("pretrain-cityscapes-b18")
    window = {k: v for k, v in line["checks"].items() if k.startswith("window_")}
    setup = {k: v for k, v in line["checks"].items() if k not in window}
    assert all(v <= lim for v, lim in setup.values()), setup
    assert any(not v <= lim for v, lim in window.values()), window


def _control(monkeypatch, cell: str, device: str = "cpu"):
    from portbench import controls
    from portbench.lib import compare, spec

    shrink(monkeypatch, device)
    line, res = run_cell(cell)
    c = spec.cell(cell)
    readings = controls.readings_for(spec.config(c["config"]), c)[0](res["kept"])
    ok, checks = compare.judge(readings["control"], c["limits"])
    return ok, checks


def test_control_is_not_correct(monkeypatch):
    """fp8 convolutions, forward and backward, and a warp stored a type
    below the configuration's, in the program's place."""
    ok, checks = _control(monkeypatch, "adapt-kitti-seq")
    assert not ok, checks


def test_covio_control_is_not_correct(monkeypatch):
    """The same control in the place of CoVIO's served frames and updates."""
    ok, checks = _control(monkeypatch, "adapt-kitti-covio-async")
    assert not ok, checks


@pytest.mark.gpu
def test_tf32_control_is_not_correct(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card; the CPU computes float32 in full")
    ok, checks = _control(monkeypatch, "pretrain-cityscapes-b18", "cuda")
    assert not ok, checks
