"""The trainer's host side in the port against the JAX package: the text
codec and edit distance, the CER statistics, the loader's batches, the
configuration; and the port's own checkpoint round trip, export and
device copies. Everything here is exact: integers, strings and arrays
compared for equality (float32 CER as Python floats, equal)."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from ocrs_models_tpu import config as jax_config
from ocrs_models_tpu.data.loader import DataLoader as JaxDataLoader
from ocrs_models_tpu.utils import text as jax_text
from ocrs_models_tpu.utils.metrics import RecognitionAccuracyStats as JaxStats
from ocrs_models_tpu.utils.profiling import Throughput as JaxThroughput
from ocrs_models_torch import config
from ocrs_models_torch.data.loader import DataLoader, device_prefetch, to_device
from ocrs_models_torch.export.onnx_check import check_bytes
from ocrs_models_torch.models import RecognitionModel
from ocrs_models_torch.training.export_utils import export_weights, read_npz
from ocrs_models_torch.training.state import create_train_state
from ocrs_models_torch.training.steps import make_recognition_steps
from ocrs_models_torch.utils import text
from ocrs_models_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from ocrs_models_torch.utils.logging import MetricsLogger
from ocrs_models_torch.utils.metrics import RecognitionAccuracyStats
from ocrs_models_torch.utils.profiling import Throughput
from ocrs_models_torch.weights import recognition_state_dict_from_jax

ALPHABET = config.DEFAULT_ALPHABET


def _random_strings(seed, n=200, chars=ALPHABET + "éü\t"):
    rng = np.random.default_rng(seed)
    return ["".join(chars[i] for i in rng.integers(0, len(chars), int(rng.integers(0, 25))))
            for _ in range(n)]


def test_configs_match_jax():
    import dataclasses

    for ours, theirs in ((config.RecognitionTrainConfig(), jax_config.RecognitionTrainConfig()),
                         (config.RecognitionModelConfig(), jax_config.RecognitionModelConfig())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert config.RecognitionModelConfig().n_classes == 97


def test_encode_and_decode_match_jax():
    for s in _random_strings(0):
        got = text.encode_text(s, ALPHABET)
        np.testing.assert_array_equal(got, jax_text.encode_text(s, ALPHABET))
        assert got.dtype == np.int32
    rng = np.random.default_rng(1)
    for _ in range(200):
        ids = rng.integers(0, 97, int(rng.integers(0, 40)))
        ids[rng.random(len(ids)) < 0.3] = 0  # blanks
        if len(ids) > 3:
            ids[2] = ids[1]  # a repeat
        assert text.ctc_greedy_decode_text(ids, ALPHABET) == \
            jax_text.ctc_greedy_decode_text(ids, ALPHABET)
        assert text.decode_text(ids, ALPHABET) == jax_text.decode_text(ids, ALPHABET)


def test_levenshtein_matches_jax():
    a, b = _random_strings(2), _random_strings(3)
    for x, y in zip(a, b):
        assert text.levenshtein(x, y) == jax_text.levenshtein(x, y), (x, y)
        assert text.levenshtein(x, x[1:] + "Z") == jax_text.levenshtein(x, x[1:] + "Z")
    assert text.levenshtein("kitten", "sitting") == 3
    assert text.levenshtein("", "abc") == 3 and text.levenshtein("abc", "") == 3


def test_recognition_stats_match_jax():
    rng = np.random.default_rng(4)
    ours, theirs = RecognitionAccuracyStats(ALPHABET), JaxStats(ALPHABET)
    for _ in range(5):
        n, lmax, t = 6, 12, 30
        targets = rng.integers(1, 97, (n, lmax))
        target_len = rng.integers(0, lmax + 1, n)
        preds = rng.integers(0, 97, (n, t))
        preds[rng.random((n, t)) < 0.5] = 0
        pred_len = rng.integers(0, t + 1, n)
        ours.update(targets, target_len, preds, pred_len)
        theirs.update(targets, target_len, preds, pred_len)
    assert (ours.char_errors, ours.total_chars) == (theirs.char_errors, theirs.total_chars)
    assert ours.char_error_rate() == theirs.char_error_rate()
    assert ours.stats_dict() == theirs.stats_dict()
    assert RecognitionAccuracyStats(ALPHABET).char_error_rate() == 0.0


class _Indices:
    """A dataset whose sample is its own index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


def _indices(loader, epochs=3):
    return [[list(map(int, b)) for b in loader] for _ in range(epochs)]


@pytest.mark.parametrize("kw", [
    {}, {"shuffle": True, "seed": 1234}, {"shuffle": True, "seed": 7, "drop_last": True},
    {"shuffle": True, "seed": 3, "process_index": 1, "process_count": 3},
    {"process_index": 2, "process_count": 4, "drop_last": True},
])
def test_loader_batches_match_jax(kw):
    ours = DataLoader(_Indices(53), 8, np.asarray, num_threads=3, **kw)
    theirs = JaxDataLoader(_Indices(53), 8, np.asarray, num_threads=3, **kw)
    assert len(ours) == len(theirs)
    got, want = _indices(ours), _indices(theirs)
    assert got == want
    if kw.get("shuffle"):
        assert got[0] != got[1]  # a new order each epoch


def test_loader_surfaces_a_worker_error():
    class Broken(_Indices):
        def __getitem__(self, i):
            if i == 11:
                raise KeyError("sample 11 is broken")
            return i

    loader = DataLoader(Broken(40), 4, np.asarray)
    with pytest.raises(KeyError, match="sample 11"):
        for _ in loader:
            pass


def test_loader_does_not_hang_when_the_consumer_stops_early():
    before = threading.active_count()
    loader = DataLoader(_Indices(1000), 2, np.asarray, prefetch=1)
    it = iter(loader)
    next(it)
    it.close()  # the consumer's finally sets the stop flag
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    assert [list(b) for b in DataLoader(_Indices(0), 2, np.asarray)] == []


def test_device_prefetch_keeps_order_and_host_batches():
    batches = [{"image": np.full((2, 3), i, np.float32), "text": np.arange(i + 1)} for i in range(5)]
    out = list(device_prefetch(iter(batches), torch.device("cpu"), depth=2))
    assert len(out) == 5
    for i, (host, dev_batch) in enumerate(out):
        assert host is batches[i]
        for key, value in host.items():
            assert isinstance(dev_batch[key], torch.Tensor)
            np.testing.assert_array_equal(dev_batch[key].numpy(), value)
    strided = np.arange(12.0).reshape(3, 4)[:, ::2]
    assert to_device({"a": strided}, torch.device("cpu"))["a"].is_contiguous()


def test_throughput_matches_jax_contract():
    ours, theirs = Throughput(warmup=1), JaxThroughput(warmup=1, n_chips=1)
    for counter in (ours, theirs):
        counter.update(100)
        assert counter.last_rate == 0.0  # the warm-up update is excluded
        time.sleep(0.01)
        counter.update(10)
        assert 0 < counter.last_rate < 10 / 0.01
    assert ours.n_chips == 1


def test_metrics_logger_writes_the_jax_records(tmp_path, monkeypatch):
    from ocrs_models_tpu.utils.logging import MetricsLogger as JaxLogger

    monkeypatch.delenv("WANDB_API_KEY", raising=False)
    records = []
    for i, cls in enumerate((MetricsLogger, JaxLogger)):
        run_dir = tmp_path / str(i)
        run_dir.mkdir()
        logger = cls("text-recognition", run_dir=str(run_dir), config={"batch_size": 20})
        logger.log({"train_loss": 1.5, "val_accuracy": {"char_error_rate": 0.5}}, step=3)
        lines = (run_dir / "text-recognition-metrics.jsonl").read_text().splitlines()
        recs = [json.loads(line) for line in lines]
        for r in recs:
            assert isinstance(r.pop("time"), float)
        records.append(recs)
    assert records[0] == records[1] == [
        {"event": "config", "batch_size": 20},
        {"train_loss": 1.5, "val_accuracy": {"char_error_rate": 0.5}, "epoch": 3},
    ]


def _trained_state(seed=0):
    torch.manual_seed(seed)
    model = RecognitionModel(n_classes=97, gru_hidden=16)
    state = create_train_state(model, grad_clip_norm=4.0)
    train_step, _ = make_recognition_steps(model)
    rng = np.random.default_rng(seed)
    batch = {"image": rng.uniform(-0.5, 0.5, (4, 1, 64, 32)).astype(np.float32),
             "text": rng.integers(1, 97, (4, 4)).astype(np.int32),
             "text_len": np.asarray([4, 3, 2, 1], np.int32),
             "image_width": np.full(4, 32, np.int32),
             "sample_weight": np.ones(4, np.float32)}
    for _ in range(2):
        state, _ = train_step(state, batch, 1e-3)
    return state


def test_checkpoint_round_trip_restores_weights_buffers_adam_and_step(tmp_path):
    state = _trained_state()
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, state, epoch=5)
    assert [p.name for p in tmp_path.iterdir()] == ["ckpt.pt"]  # no temporary left
    fresh = create_train_state(RecognitionModel(n_classes=97, gru_hidden=16), grad_clip_norm=4.0)
    fresh, epoch = load_checkpoint(path, fresh)
    assert epoch == 5 and fresh.step == 2
    want, got = state.model.state_dict(), fresh.model.state_dict()
    assert want.keys() == got.keys()
    for key in want:  # weights and batch-norm buffers (running stats, counts)
        assert torch.equal(want[key], got[key]), key
    a, b = state.optimizer.adam.state_dict(), fresh.optimizer.adam.state_dict()
    assert a["param_groups"] == b["param_groups"]
    assert a["state"].keys() == b["state"].keys() and len(a["state"]) == len(state.optimizer.params)
    for i, s in a["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s[key], b["state"][i][key]), (i, key)
    assert float(b["state"][0]["step"]) == 2


def test_checkpoint_with_empty_optimizer_state_loads_weights_and_a_fresh_adam(tmp_path):
    state = _trained_state(1)
    path = str(tmp_path / "w.pt")
    export_weights(state, path, model="recognition", epoch=3)
    saved = torch.load(path, weights_only=True)
    assert saved["optimizer_state"] == {} and saved["epoch"] == 3
    fresh = create_train_state(RecognitionModel(n_classes=97, gru_hidden=16))
    fresh, epoch = load_checkpoint(path, fresh)
    assert epoch == 3 and fresh.step == 0 and fresh.optimizer.adam.state_dict()["state"] == {}
    for key, value in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[key], value), key
    with pytest.raises(FileNotFoundError, match="missing.pt"):
        load_checkpoint(str(tmp_path / "missing.pt"), fresh)


@pytest.mark.parametrize("name,error,match", [
    ("w.bin", ValueError, r"use \.npz, \.pt or \.onnx"),
])
def test_export_refuses_formats_not_ported(tmp_path, name, error, match):
    state = create_train_state(RecognitionModel(n_classes=97, gru_hidden=16))
    with pytest.raises(error, match=match):
        export_weights(state, str(tmp_path / name))
    assert not (tmp_path / name).exists()


@pytest.mark.parametrize("name", ["w.npz", "w.onnx"])
def test_export_writes_npz_and_onnx(tmp_path, name):
    """A narrow recognizer (H=16): the ``.onnx`` graph takes its hidden size
    from the model and passes the checker; the ``.npz`` maps back to the
    state dict, every tensor equal but ``num_batches_tracked``."""
    model = RecognitionModel(n_classes=97, gru_hidden=16)
    export_weights(create_train_state(model), str(tmp_path / name))
    if name.endswith(".onnx"):
        graph = check_bytes((tmp_path / name).read_bytes()).graph
        gru = [n for n in graph.nodes if n.op_type == "GRU"]
        assert [n.attrs["hidden_size"] for n in gru] == [16, 16]
        return
    sd = recognition_state_dict_from_jax(read_npz(tmp_path / name))
    for key, value in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(sd[key], value), key
