"""The adapting iteration as a CUDA graph (`train/steps.py`,
`IterationGraph`): when it is used, and that it changes nothing.

On the CPU the graph's capture and replay are stood in for by running the
iteration eagerly on the graph's static inputs (`_EagerGraph`), so the rule
that engages it, the static copies, the gradients it leaves for Adam and
the fresh tensors the steps return are held to the eager path bit for bit.
On the card (`gpu`) the real graph is held to the eager path over four
frames of the adapting cell's shapes, on the K1 route and the fused stack.
"""
import pytest
import torch

from tpuslam_torch import full_fp32, tracing
from tpuslam_torch.losses.photometric import tie_break_noise
from tpuslam_torch.train import steps
from tpuslam_torch.train.state import clone_train_state
from tpuslam_torch.train.steps import (IterationGraph, LossConfig, adapt_step,
                                       consolidate_step)
from tpuslam_torch.utils.profiling import adapt_state, random_training_batch

K_ITERS = 2


@pytest.fixture(autouse=True)
def _tracer_on():
    tracing.reset()
    tracing.enable()
    yield
    tracing.disable()
    tracing.reset()


class _EagerGraph(IterationGraph):
    """`IterationGraph` with its capture and replay run eagerly on the CPU:
    the capture runs the iteration once, and each replay zeroes the
    gradients it holds in place, runs the iteration again, with the tracer
    off as a graph's replay runs no Python, and copies the results into the
    tensors the capture returned."""

    def _record(self, fn):
        self.fn = fn
        return fn()

    def _replay(self) -> None:
        for _, g in self.grads:
            g.zero_()
        was, tracing.on = tracing.on, False
        try:
            losses, outputs = self.fn()
        finally:
            tracing.on = was
        for mine, new in ((self.losses, losses), (self.outputs, outputs)):
            for k, v in new.items():
                mine[k].copy_(v.detach())


@pytest.fixture
def graphed(monkeypatch):
    """Graphs engaged on the CPU, run by `_EagerGraph`."""
    monkeypatch.setattr(steps, "_graphable", lambda device: True)
    monkeypatch.setattr(steps, "IterationGraph", _EagerGraph)


def _cfg(**kw) -> LossConfig:
    return LossConfig(bf16_networks=False, **kw)


def _frames(n: int, height=32, width=96, batch=3):
    return [random_training_batch(height, width, batch, 100 + i, "cpu") for i in range(n)]


def _state_of(state) -> dict:
    opt = state.optimizer
    return {"params": {n: p.detach().clone() for n, p in state.model.named_parameters()
                       if n.startswith(("depth_decoder.", "pose_decoder."))},
            "m": [opt.state[p]["exp_avg"].clone() for p in opt.state],
            "v": [opt.state[p]["exp_avg_sq"].clone() for p in opt.state],
            "rng": state.rng.get_state()}


def _equal(a: dict, b: dict) -> None:
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
    assert all(torch.equal(x, y) for x, y in zip(a["m"] + a["v"], b["m"] + b["v"]))
    assert torch.equal(a["rng"], b["rng"])


def _counters() -> dict:
    return tracing.snapshot()["counters"]


def test_cpu_stays_eager():
    """On the CPU no graph is built, whatever the number of frames."""
    state = adapt_state(0, "cpu")
    for batch in _frames(3):
        adapt_step(state, _cfg(), batch, K_ITERS)
    assert state.graph is None and state.graph_key is None
    assert "graph.capture" not in _counters()
    assert "step.graph" not in tracing.snapshot()["spans"]


def test_graph_from_second_call_matches_eager(graphed, monkeypatch):
    """First call eager, second captures and replays, later ones replay;
    iteration losses, decoders, Adam's moments and the generator equal
    the eager path's after every frame."""
    frames = _frames(4)
    state = adapt_state(0, "cpu")
    eager = clone_train_state(state)
    got, want = [], []
    for i, batch in enumerate(frames):
        losses, _ = adapt_step(state, _cfg(), batch, K_ITERS)
        got.append((losses["iter_losses"], _state_of(state)))
        counters = _counters()
        assert counters.get("graph.capture", 0) == (0 if i == 0 else 1)
        assert counters.get("graph.replay", 0) == K_ITERS * i
        assert (state.graph is None) == (i == 0)
    monkeypatch.setattr(steps, "_graphable", lambda device: False)
    for batch in frames:
        losses, _ = adapt_step(eager, _cfg(), batch, K_ITERS)
        want.append((losses["iter_losses"], _state_of(eager)))
    assert eager.graph is None
    for (gl, gs), (wl, ws) in zip(got, want):
        assert torch.equal(gl, wl)
        _equal(gs, ws)


def test_graph_spans(graphed):
    """A replayed iteration holds `step.graph` and `step.adam`; decode,
    warp and loss and backward fire on the eager frame and the capture."""
    state = adapt_state(0, "cpu")
    for batch in _frames(3):
        adapt_step(state, _cfg(), batch, K_ITERS)
    spans = tracing.snapshot()["spans"]
    assert spans["step.iter"]["count"] == 3 * K_ITERS
    assert spans["step.graph"]["count"] == 2 * K_ITERS
    assert spans["step.adam"]["count"] == 3 * K_ITERS
    for name in ("step.decode", "step.warp_loss", "step.backward"):
        assert spans[name]["count"] == K_ITERS + 1, name


def _change(what: str, state, cfg, batch):
    """A state, config and batch that differ from the given ones in `what`."""
    if what == "shape":
        return state, cfg, random_training_batch(32, 96, 2, 7, "cpu")
    if what == "loss_config":
        return state, cfg._replace(disparity_smoothness=2e-3), batch
    if what == "data_ptr":
        p = next(state.model.pose_decoder.parameters())
        p.data = p.data.clone()
        return state, cfg, batch
    if what == "gradients_dropped":
        state.optimizer.zero_grad(set_to_none=True)
        return state, cfg, batch
    raise ValueError(what)


@pytest.mark.parametrize("what", ["shape", "loss_config", "data_ptr"])
def test_changed_key_recaptures(graphed, what):
    """After a capture, a change of the batch's shapes, the LossConfig or a
    decoder parameter's storage runs the next frame eagerly and drops the
    graph; the frame after it captures anew and later ones replay."""
    state = adapt_state(0, "cpu")
    cfg = _cfg()
    batch, = _frames(1)
    for _ in range(2):
        adapt_step(state, cfg, batch, K_ITERS)
    first = state.graph
    assert first is not None
    state, cfg, batch = _change(what, state, cfg, batch)
    adapt_step(state, cfg, batch, K_ITERS)
    assert state.graph is None and _counters()["graph.capture"] == 1
    adapt_step(state, cfg, batch, K_ITERS)
    assert state.graph is not None and state.graph is not first
    adapt_step(state, cfg, batch, K_ITERS)
    assert _counters()["graph.capture"] == 2
    assert _counters()["graph.replay"] == 3 * K_ITERS


def test_dropped_gradients_recapture(graphed):
    """Gradients set to None after the capture make the graph's gradients
    unreachable by Adam: the next frame, with the same key, captures anew."""
    state = adapt_state(0, "cpu")
    batch, = _frames(1)
    for _ in range(2):
        adapt_step(state, _cfg(), batch, K_ITERS)
    first = state.graph
    _change("gradients_dropped", state, _cfg(), batch)
    adapt_step(state, _cfg(), batch, K_ITERS)
    assert state.graph is not first and _counters()["graph.capture"] == 2


def test_clone_used_once_stays_eager(graphed):
    """A clone consolidated once (the CoVIO update) never captures; a state
    consolidated on every call with one key does, from its second call."""
    state = adapt_state(0, "cpu")
    batch, = _frames(1)
    for _ in range(3):
        clone = clone_train_state(state)
        assert clone.graph is None
        consolidate_step(clone, _cfg(), batch, K_ITERS)
        assert clone.graph is None
    assert "graph.capture" not in _counters()
    for _ in range(2):
        consolidate_step(state, _cfg(), batch, K_ITERS)
    assert _counters()["graph.capture"] == 1 and state.graph is not None


def test_returned_tensors_outlive_later_frames(graphed):
    """What a graphed frame returns (losses, outputs, iteration losses) is
    fresh: the next frame's replays leave it as it was."""
    state = adapt_state(0, "cpu")
    frames = _frames(4)
    for batch in frames[:2]:
        adapt_step(state, _cfg(), batch, K_ITERS)
    losses, outputs = adapt_step(state, _cfg(), frames[2], K_ITERS)
    kept = ({k: v.clone() for k, v in losses.items()},
            {k: v.clone() for k, v in outputs.items()})
    adapt_step(state, _cfg(), frames[3], K_ITERS)
    for now, then in ((losses, kept[0]), (outputs, kept[1])):
        for k, v in then.items():
            assert torch.equal(now[k], v), k
    assert len(set(kept[0]["iter_losses"].tolist())) == K_ITERS


def _scan_noise_inside(state, cfg, training, num_steps):
    """`_adapt_scan`'s loop as it was with the tie-break noise drawn inside
    `total_loss` from `rng`: the iteration losses."""
    model, opt = state.model, state.optimizer
    depth_feats, pose_feat = steps._frozen_features(model, training, cfg)
    with torch.no_grad():
        identity_base = steps.identity_reprojection({
            ("rgb", 0, 0): training.frame(0), ("rgb", -1, 0): training.frame(-1),
            ("rgb", 1, 0): training.frame(1)})
        pyramid = steps._image_pyramid(training.frame(0), len(cfg.scales))
    out = []
    for _ in range(num_steps):
        losses, _ = steps._decode_and_loss(model, training, cfg, depth_feats, pose_feat,
                                           rng=state.rng, identity_base=identity_base,
                                           pyramid=pyramid)
        opt.zero_grad(set_to_none=True)
        losses["loss"].backward()
        opt.step()
        out.append(losses["loss"].detach())
    return torch.stack(out)


def test_noise_drawn_outside_total_loss_is_bit_identical():
    """The eager `_adapt_scan`, which draws the noise before each iteration
    and hands it to `total_loss`, gives the iteration losses, decoders,
    Adam state and generator state of the noise drawn inside it."""
    state = adapt_state(0, "cpu")
    inside = clone_train_state(state)
    for batch in _frames(2, height=16, width=64):
        _, _, got, _ = steps._adapt_scan(state, _cfg(), batch, 3, with_outputs=False)
        want = _scan_noise_inside(inside, _cfg(), batch, 3)
        assert torch.equal(got, want)
        _equal(_state_of(state), _state_of(inside))


def test_tie_break_noise_is_total_loss_draw():
    """`total_loss` given `rng` draws exactly `tie_break_noise`."""
    base = torch.rand(2, 2, 8, 12)
    a = tie_break_noise(torch.Generator().manual_seed(3), base, 4)
    gen = torch.Generator().manual_seed(3)
    b = 1e-5 * torch.randn((4, 1, 2, 8, 12), generator=gen)
    assert a.shape == (4, 1, 2, 8, 12) and torch.equal(a, b)


def test_tally_takes_the_prefixed_counts_of_every_thread():
    """`tracing.tally(prefix)` gathers the counts under `prefix` made on any
    thread while it is open, in place of the counters, with the tracer on
    or off, and does not nest."""
    import threading

    for tracer in (False, True):
        tracing.reset()
        tracing.on = tracer
        with tracing.tally("launches.") as counts:
            tracing.count("launches.a")
            tracing.count("h2d_bytes", 5)
            worker = threading.Thread(target=tracing.count, args=("launches.b", 3))
            worker.start()
            worker.join(timeout=10)
            assert not worker.is_alive()
            with pytest.raises(RuntimeError):
                with tracing.tally("launches."):
                    pass
        tracing.count("launches.a")
        assert counts == {"launches.a": 1, "launches.b": 3}
        assert _counters() == ({"h2d_bytes": 5, "launches.a": 1} if tracer else {})


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# the adapting cell's shapes: 192 x 640, batch 3, K = 5, ResNet-18, bf16
# networks, K1 with float32 stores
CARD_H, CARD_W, CARD_K, CARD_FRAMES = 192, 640, 5, 4
FUSED = dict(pallas_tall=True, pallas_proj=True, pallas_fused_loss=True, pallas_fused_bwd=True)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the port's kernels have no CPU build")
    return torch.device("cuda")


class _Recorder:
    """Records, at each optimizer step of a state, the decoders it starts
    from, the gradients it reads and Adam's state; and each tie-break
    noise drawn."""

    def __init__(self, state, monkeypatch):
        import copy

        opt = state.optimizer
        self.params = [p for g in opt.param_groups for p in g["params"]]
        self.steps, self.noise = [], []

        def step(*a, **kw):
            self.steps.append({"params": [p.detach().clone() for p in self.params],
                               "grads": [p.grad.clone() for p in self.params],
                               "adam": copy.deepcopy(opt.state_dict())})
            return type(opt).step(opt, *a, **kw)

        def noise(*a, **kw):
            out = tie_break_noise(*a, **kw)
            self.noise.append(out.clone())
            return out

        opt.step = step
        monkeypatch.setattr(steps, "tie_break_noise", noise)


def _eager_iteration(twin, cfg, batch, params, noise):
    """An eager iteration of `twin` from the decoders `params`: its loss
    and gradients."""
    opt = twin.optimizer
    mine = [p for g in opt.param_groups for p in g["params"]]
    with torch.no_grad():
        for p, q in zip(mine, params):
            p.copy_(q)
    opt.zero_grad(set_to_none=True)
    with full_fp32():
        losses, _ = steps.adapt_iteration(twin.model, cfg,
                                          steps.frame_inputs(twin.model, cfg, batch), noise)
    return losses["loss"].detach(), [p.grad.clone() for p in mine]


def _leaf_gaps(a, b):
    return [float((x - y).norm() / y.norm()) for x, y in zip(a, b) if float(y.norm()) > 0]


ROUTES = {"k1": dict(pallas_bf16_out=False), "fused": dict(pallas_bf16_out=False, **FUSED),
          "k1_float32": dict(pallas_bf16_out=False, bf16_networks=False)}


@pytest.mark.gpu
@pytest.mark.parametrize("route", list(ROUTES))
def test_graph_matches_eager_on_card(monkeypatch, route):
    """Four frames, graphed from the second, on the K1 route, the fused
    stack (K4-K8) and K1 with float32 networks: one capture, 3 x K
    replays, the launches an eager run counts, the generator's state of the
    eager run after each frame, and each frame's returned tensors unchanged
    by the next frame.  Each iteration against an eager one from the
    decoders and noise it ran with: the loss within 1e-6 relative, the
    gradients Adam read within 10x the gap between two eager runs (the
    backward's atomic sums, of reflection padding and bilinear resizing,
    differ from run to run: ~5e-3 of a leaf with bf16 networks); and the
    Adam steps taken from them give the decoders and moments the state
    holds, bit for bit.  The trajectories of two whole runs drift apart
    through Adam from those gaps, eager against eager as well."""
    _card()
    cfg = LossConfig(**ROUTES[route])
    frames = [random_training_batch(CARD_H, CARD_W, 3, 200 + i, "cuda")
              for i in range(CARD_FRAMES)]
    eager = adapt_state(0, "cuda")
    monkeypatch.setattr(steps, "_graphable", lambda device: False)
    tracing.reset()
    eager_rng = []
    for batch in frames:
        adapt_step(eager, cfg, batch, CARD_K)
        eager_rng.append(eager.rng.get_state())
    eager_launches = {k: v for k, v in _counters().items() if k.startswith("launches.")}

    monkeypatch.setattr(steps, "_graphable", lambda device: True)
    state = adapt_state(0, "cuda")
    rec = _Recorder(state, monkeypatch)
    tracing.reset()
    returned = []
    for i, batch in enumerate(frames):
        losses, outputs = adapt_step(state, cfg, batch, CARD_K)
        assert torch.equal(state.rng.get_state(), eager_rng[i]), f"frame {i} generator"
        returned.append((losses, outputs, {k: v.clone() for k, v in losses.items()},
                         {k: v.clone() for k, v in outputs.items()}))
    counts = _counters()
    assert counts["graph.capture"] == 1 and counts["graph.replay"] == 3 * CARD_K
    assert {k: v for k, v in counts.items() if k.startswith("launches.")} == eager_launches
    for losses, outputs, losses_then, outputs_then in returned:
        for now, then in ((losses, losses_then), (outputs, outputs_then)):
            for k, v in then.items():
                assert torch.equal(now[k], v), k

    twin = adapt_state(0, "cuda")
    monkeypatch.setattr(steps, "_graphable", lambda device: False)
    final = [p.detach().clone() for p in rec.params]
    gaps, floor = [], []
    for j, taken in enumerate(rec.steps):
        i, k = divmod(j, CARD_K)
        loss, grads = _eager_iteration(twin, cfg, frames[i], taken["params"], rec.noise[j])
        again, grads2 = _eager_iteration(twin, cfg, frames[i], taken["params"], rec.noise[j])
        graph_loss = returned[i][2]["iter_losses"][k]
        assert abs(float(graph_loss) - float(loss)) <= 1e-6 * abs(float(loss)), (i, k)
        gaps.append(max(_leaf_gaps(taken["grads"], grads)))
        floor.append(max(_leaf_gaps(grads2, grads)))
        # Adam from the state the graph's step started in, on its gradients
        opt = twin.optimizer
        mine = [p for g in opt.param_groups for p in g["params"]]
        opt.load_state_dict(taken["adam"])
        with torch.no_grad():
            for p, q, g in zip(mine, taken["params"], taken["grads"]):
                p.copy_(q)
                p.grad = g.clone()
        type(opt).step(opt)
        after = rec.steps[j + 1]["params"] if j + 1 < len(rec.steps) else final
        assert all(torch.equal(p, q) for p, q in zip(mine, after)), (i, k)
        if j + 1 < len(rec.steps):
            want = rec.steps[j + 1]["adam"]["state"]
            got = opt.state_dict()["state"]
            assert all(torch.equal(got[n][m], want[n][m]) for n in want
                       for m in ("exp_avg", "exp_avg_sq")), (i, k)
    print(f"{route}: gradient gap graph-eager max {max(gaps):.3g}, eager-eager max "
          f"{max(floor):.3g}")
    assert len(rec.steps) == CARD_FRAMES * CARD_K
    assert max(gaps) <= max(10 * max(floor), 1e-6)
