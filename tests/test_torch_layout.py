"""The port's layout model, its data and its serving against the JAX
package's, on the CPU, from the same weights and inputs.

Weights are drawn with numpy from a seed (``layout_variables``) and go to
the port through ``weights.layout_state_dict_from_jax``. Models are small
(d_model 32, 2 layers, 2 heads, FF 64) on pages of 16-40 words, but for
the pipeline, which builds the layout model at the reference's width.

Tolerances, and why:

- ``sinusoidal_bbox_encoding``: the rounded coordinates equal (half to
  even) and the encodings within 2e-7 (torch's and XLA's ``sin``/``cos`` of
  equal float32 angles up to 1000 rad; read 6e-8).
- f32 layer and model outputs: 5e-6 (LayerNorm's variance is E[x^2] -
  E[x]^2 in flax and not in torch; read 7e-7 for the sinusoidal model and
  up to 5.5e-6 for the MLP embedding, whose inputs are raw pixels).
- bf16: the port holds flax's rounding points, and on this CPU its bf16
  products round as XLA's, so outputs read within 6e-7 of JAX's bf16
  model. The check is ``test_torch_bf16.py``'s band method all the same:
  the bf16 effect (bf16 output less f32 output) of the port and of JAX of
  the same size (RMS ratio within [0.5, 1.5]; read 1.000) and direction
  (correlation at least 0.9; read 1.000), plus 1e-2 on the outputs.
- ``weighted_bce_with_logits``: 1e-6 relative (float32 sums in another
  order), its gradient 1e-6 absolute.
- datasets, collation, statistics, rendering: equal, bit for bit.
- line grouping: equal, on pages where no probability lies within 1e-4 of
  the 0.5 threshold (the tests check that margin: a probability nearer to
  it could flip with the last bits); layout probabilities 1e-5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ocrs_models_tpu.models.layout as jax_layout
from ocrs_models_tpu.data import SyntheticDetection
from ocrs_models_tpu.data import layout_synth as jax_synth
from ocrs_models_tpu.data import web_layout as jax_web
from ocrs_models_tpu.data.collate import collate_layout as jax_collate_layout
from ocrs_models_tpu.data.synthetic import SyntheticLayout as JaxSyntheticLayout
from ocrs_models_tpu.export.torch_export import export_layout_state_dict
from ocrs_models_tpu.models import DetectionModel as JaxDetection
from ocrs_models_tpu.models import RecognitionModel as JaxRecognition
from ocrs_models_tpu.ops.losses import weighted_bce_with_logits as jax_bce
from ocrs_models_tpu.pipeline import OcrPipeline as JaxPipeline
from ocrs_models_tpu.pipeline import group_lines_from_layout_probs as jax_group_from_probs
from ocrs_models_tpu.utils import metrics as jax_metrics
from ocrs_models_torch.data import SyntheticLayout, collate_layout, layout_synth, web_layout
from ocrs_models_torch.models import LayoutModel
from ocrs_models_torch.models.layout import EncoderLayer, sinusoidal_bbox_encoding
from ocrs_models_torch.ops.losses import weighted_bce_with_logits
from ocrs_models_torch.pipeline import OcrPipeline, group_lines_from_layout_probs
from ocrs_models_torch.utils import metrics
from ocrs_models_torch.weights import layout_state_dict_from_jax
from torch_port_common import layout_variables, patch_jax_dropout, random_variables

SMALL = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64)
FIXTURE_DIR = "tests/data/scraper_fixture"
DET_SIZE = (128, 96)


def _pages(n_pages: int, n_words: int, seed: int = 0) -> np.ndarray:
    """Word boxes of synthetic pages (raw pixels, zero-padded to
    ``n_words``)."""
    ds = SyntheticLayout(size=n_pages, n_words=n_words, seed=seed)
    return np.stack([ds[i][0] for i in range(n_pages)])


def _models(pos_embedding: str, jax_dtype, torch_dtype, seed: int = 1, return_probs=False):
    jax_model = jax_layout.LayoutModel(pos_embedding=pos_embedding, dtype=jax_dtype,
                                       return_probs=return_probs, **SMALL)
    variables = layout_variables(jax_layout.LayoutModel(pos_embedding=pos_embedding, **SMALL), seed)
    port = LayoutModel(pos_embedding=pos_embedding, dtype=torch_dtype,
                       return_probs=return_probs, **SMALL)
    port.load_state_dict(
        layout_state_dict_from_jax(variables, SMALL["n_layers"], pos_embedding), strict=True)
    return jax_model, variables, port.eval()


def _forward(jax_model, variables, port, boxes):
    want = np.asarray(jax_model.apply(variables, jnp.asarray(boxes)), np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(boxes)).float().numpy()
    return got, want


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sinusoidal_encoding_matches_jax(seed):
    rng = np.random.default_rng(seed)
    boxes = rng.uniform(0.0, 1000.0, (2, 40, 4)).astype(np.float32)
    boxes[:, ::3] = np.floor(boxes[:, ::3]) + 0.5  # ties: half to even
    boxes[0, 0] = [0.5, 1.5, 2.5, 999.5]
    np.testing.assert_array_equal(torch.round(torch.from_numpy(boxes)).numpy(), np.round(boxes))
    want = np.asarray(jax_layout.sinusoidal_bbox_encoding(jnp.asarray(boxes), 64))
    got = sinusoidal_bbox_encoding(torch.from_numpy(boxes), 64).numpy()
    assert got.shape == want.shape == (2, 40, 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encoder_layer_matches_jax(dtype):
    jax_dtype, torch_dtype = {"f32": (jnp.float32, torch.float32),
                              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    _, variables, _ = _models("sin", jnp.float32, torch.float32)
    x = np.random.default_rng(3).normal(size=(3, 24, 32)).astype(np.float32)
    params = {"params": variables["params"]["layer_1"]}
    want = np.asarray(jax_layout.EncoderLayer(32, 2, 64, dtype=jax_dtype).apply(params,
                                                                               jnp.asarray(x)))
    layer = EncoderLayer(32, 2, 64, dtype=torch_dtype)
    sd = layout_state_dict_from_jax(variables, SMALL["n_layers"])
    prefix = "encode.layers.1."
    layer.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)},
                          strict=True)
    with torch.no_grad():
        got = layer.eval()(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.float32  # the residual stream stays f32
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6 if dtype == "f32" else 1e-2)


@pytest.mark.parametrize("pos_embedding", ["sin", "mlp"])
def test_layout_model_matches_jax(pos_embedding):
    boxes = _pages(3, 40)
    got, want = _forward(*_models(pos_embedding, jnp.float32, torch.float32), boxes)
    assert got.shape == want.shape == (3, 40, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)
    probs, want_probs = _forward(
        *_models(pos_embedding, jnp.float32, torch.float32, return_probs=True), boxes)
    np.testing.assert_allclose(probs, want_probs, rtol=0, atol=2e-6)
    np.testing.assert_allclose(probs, 1.0 / (1.0 + np.exp(-got)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("pos_embedding", ["sin", "mlp"])
def test_layout_model_bf16_matches_jax(pos_embedding):
    boxes = _pages(3, 40, seed=5)
    got, want = _forward(*_models(pos_embedding, jnp.bfloat16, torch.bfloat16), boxes)
    got_f32, want_f32 = _forward(*_models(pos_embedding, jnp.float32, torch.float32), boxes)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
    d_port = (got - got_f32).ravel().astype(np.float64)
    d_jax = (want - want_f32).ravel().astype(np.float64)
    assert np.linalg.norm(d_jax) > 0  # bf16 compute has an effect
    ratio = np.linalg.norm(d_port) / np.linalg.norm(d_jax)
    assert 0.5 <= ratio <= 1.5, ratio
    corr = d_port @ d_jax / (np.linalg.norm(d_port) * np.linalg.norm(d_jax))
    assert corr >= 0.9, corr


def test_bf16_model_keeps_float32_parameters_and_keys():
    f32 = LayoutModel(**SMALL)
    bf16 = LayoutModel(dtype=torch.bfloat16, **SMALL)
    assert f32.state_dict().keys() == bf16.state_dict().keys()
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    with pytest.raises(ValueError, match="dtype"):
        LayoutModel(dtype=torch.float16)
    with pytest.raises(ValueError, match="pos_embedding"):
        LayoutModel(pos_embedding="table")


@pytest.mark.parametrize("pos_embedding", ["sin", "mlp"])
def test_jax_export_loads_strictly(pos_embedding):
    _, variables, _ = _models(pos_embedding, jnp.float32, torch.float32)
    exported = export_layout_state_dict(variables, SMALL["n_layers"], pos_embedding)
    mapped = layout_state_dict_from_jax(variables, SMALL["n_layers"], pos_embedding)
    port = LayoutModel(pos_embedding=pos_embedding, **SMALL)
    assert port.state_dict().keys() == exported.keys() == mapped.keys()
    port.load_state_dict({k: torch.tensor(v) for k, v in exported.items()}, strict=True)
    for key, value in exported.items():
        assert torch.equal(mapped[key], torch.from_numpy(np.asarray(value))), key


def test_full_width_model_has_the_jax_parameter_count():
    shapes = jax.eval_shape(
        lambda: jax_layout.LayoutModel().init(jax.random.key(0), jnp.zeros((1, 8, 4))))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in LayoutModel().parameters()) == want == 4_739_074


# ------------------------------------------------------------------- loss

@pytest.mark.parametrize("weighted", [False, True])
def test_weighted_bce_matches_jax(weighted):
    rng = np.random.default_rng(7)
    logits = rng.normal(0.0, 4.0, (4, 30, 2)).astype(np.float32)
    logits[0, 0] = [60.0, -60.0]  # saturated: the log-sigmoid form stays finite
    labels = (rng.uniform(size=(4, 30, 2)) < 0.2).astype(np.float32)
    weight = np.array([1, 1, 1, 0], np.float32) if weighted else None
    jw = None if weight is None else jnp.asarray(weight)
    want, want_grad = jax.value_and_grad(
        lambda x: jax_bce(x, jnp.asarray(labels), 10.0, jw))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = weighted_bce_with_logits(x, torch.from_numpy(labels), 10.0,
                                   None if weight is None else torch.from_numpy(weight))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=0, atol=1e-6)
    if weighted:
        assert not x.grad[3].any()


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("n,batch_multiple", [(5, 1), (5, 4), (8, 4)])
def test_collate_layout_matches_jax(n, batch_multiple):
    samples = [JaxSyntheticLayout(size=8, n_words=16, seed=3)[i] for i in range(n)]
    want = jax_collate_layout(samples, batch_multiple=batch_multiple)
    got = collate_layout(samples, batch_multiple=batch_multiple)
    assert got.keys() == want.keys()
    for key in ("boxes", "labels", "sample_weight"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["n_valid"] == want["n_valid"] == n


@pytest.mark.parametrize("seed,n_words", [(0, 500), (1234, 500), (7, 40)])
def test_synthetic_layout_matches_jax(seed, n_words):
    want_ds, got_ds = JaxSyntheticLayout(4, n_words, seed), SyntheticLayout(4, n_words, seed)
    assert len(got_ds) == len(want_ds)
    for i in range(4):
        for got, want in zip(got_ds[i], want_ds[i]):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


def test_document_pages_match_jax():
    want, got = jax_synth.DocumentSynthesizer(seed=3), layout_synth.DocumentSynthesizer(seed=3)
    for i in range(3):
        assert json.dumps(got.page(i)) == json.dumps(want.page(i))


@pytest.mark.parametrize("train,normalize,randomize",
                         [(True, False, True), (False, False, False), (True, True, False)])
def test_synthetic_doc_layout_matches_jax(train, normalize, randomize):
    kwargs = dict(size=5, n_words=500, seed=1234, train=train, normalize_coords=normalize,
                  randomize=randomize, max_jitter=10)
    want_ds = jax_synth.SyntheticDocLayout(**kwargs)
    got_ds = layout_synth.SyntheticDocLayout(**kwargs)
    for i in range(5):  # in order: the jitter draws come from one generator
        for got, want in zip(got_ds[i], want_ds[i]):
            np.testing.assert_array_equal(got, want)


def test_write_corpus_and_web_layout_match_jax(tmp_path):
    layout_synth.write_corpus(str(tmp_path / "port"), 6, seed=2)
    jax_synth.write_corpus(str(tmp_path / "jax"), 6, seed=2)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    root = str(tmp_path / "port")
    for kwargs in (dict(train=True, randomize=True, padded_size=500, max_jitter=10,
                        normalize_coords=False, seed=1234),
                   dict(train=False, padded_size=500, normalize_coords=False),
                   dict(train=True, max_images=3)):
        want_ds = jax_web.WebLayout(root, **kwargs)
        got_ds = web_layout.WebLayout(root, **kwargs)
        assert got_ds._files == want_ds._files
        for i in range(len(want_ds)):
            for got, want in zip(got_ds[i], want_ds[i]):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("normalize,jitter", [(True, (0.0, 0.0)), (False, (3.25, 7.5))])
def test_extract_word_boxes_matches_jax_on_the_scraper_fixture(normalize, jitter):
    ds = web_layout.WebLayout(FIXTURE_DIR)
    assert len(ds) == len(jax_web.WebLayout(FIXTURE_DIR)) == 1
    with open(f"{FIXTURE_DIR}/{ds._files[0]}") as f:
        content = json.load(f)
    got = web_layout.extract_word_boxes(content, normalize, *jitter)
    want = jax_web.extract_word_boxes(content, normalize, *jitter)
    assert got[0].shape[0] > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(ds[0], jax_web.WebLayout(FIXTURE_DIR)[0]):
        np.testing.assert_array_equal(g, w)


def test_layout_accuracy_stats_match_jax():
    rng = np.random.default_rng(4)
    want, got = jax_metrics.LayoutAccuracyStats(), metrics.LayoutAccuracyStats()
    for _ in range(3):
        probs = rng.uniform(size=(4, 50, 2)).astype(np.float32)
        probs[0, :3] = 0.5  # at the threshold: a positive (>=)
        targets = (rng.uniform(size=(4, 50, 2)) < 0.3).astype(np.float32)
        want.update(probs, targets)
        got.update(probs, targets)
    got.update(np.zeros((1, 5, 2)), np.zeros((1, 5, 2)))  # 0/0 counts as 0
    want.update(np.zeros((1, 5, 2)), np.zeros((1, 5, 2)))
    assert got.stats_dict() == want.stats_dict()
    assert got.summary() == want.summary()
    assert metrics.LayoutAccuracyStats().stats_dict() == jax_metrics.LayoutAccuracyStats().stats_dict()
    for p, r in ((0.0, 0.0), (0.5, 0.25), (1.0, 1.0)):
        assert metrics.f1_score(p, r) == jax_metrics.f1_score(p, r)
    preds, targets = rng.uniform(size=40) < 0.5, rng.uniform(size=40) < 0.5
    assert metrics.precision_recall(preds, targets) == jax_metrics.precision_recall(preds, targets)


# -------------------------------------------------------------- grouping

GROUPING_CASES = {
    "splits_at_starts": (
        [[10, 10, 60, 30], [70, 12, 120, 32], [10, 50, 80, 70], [90, 50, 140, 70]],
        [[0.9, 0.1], [0.1, 0.8], [0.95, 0.1], [0.1, 0.9]]),
    "end_forces_break": (
        [[0, 0, 10, 10], [20, 0, 30, 10], [40, 0, 50, 10]],
        [[0.9, 0.0], [0.0, 0.9], [0.0, 0.0]]),
    "leading_non_start": ([[0, 0, 10, 10], [20, 0, 30, 10]], [[0.1, 0.0], [0.1, 0.0]]),
    "guard_vetoes_merge": (
        [[0, 0, 10, 10], [20, 0, 30, 10], [0, 40, 10, 50]],
        [[0.9, 0.0], [0.1, 0.0], [0.1, 0.0]]),
    "guard_keeps_same_row": (
        [[0, 0, 10, 10], [20, 2, 30, 12], [40, 1, 50, 11]],
        [[0.9, 0.0], [0.1, 0.0], [0.1, 0.0]]),
    "at_threshold": ([[0, 0, 10, 10], [20, 0, 30, 10], [40, 0, 50, 10]],
                     [[0.5, 0.0], [0.5, 0.5], [0.0, 0.0]]),
    "empty": (np.zeros((0, 4)), np.zeros((0, 2))),
}


@pytest.mark.parametrize("case", sorted(GROUPING_CASES))
@pytest.mark.parametrize("guard", [True, False])
def test_group_lines_from_layout_probs_matches_jax(case, guard):
    boxes, probs = (np.asarray(a, np.float32) for a in GROUPING_CASES[case])
    want = jax_group_from_probs(boxes, probs, geometry_guard=guard)
    got = group_lines_from_layout_probs(boxes, probs, geometry_guard=guard)
    assert [m for _, m in got] == [m for _, m in want]
    for (gb, _), (wb, _) in zip(got, want):
        np.testing.assert_array_equal(gb, wb)
    if case == "guard_vetoes_merge":
        assert [m for _, m in got] == ([[0, 1], [2]] if guard else [[0, 1, 2]])


class _AllStarts(torch.nn.Module):
    """A stand-in layout model: every word a confident line start."""

    def forward(self, boxes):
        return torch.tensor([1.0, 0.0]).expand(*boxes.shape[:2], 2)


def test_layout_grouping_overflow_words_become_lines():
    pipe = OcrPipeline(device="cpu", use_layout_model=True,
                       layout_state_dict=LayoutModel(return_probs=True).state_dict(),
                       layout_pad_words=4)
    pipe.layout_model = _AllStarts()
    quads = np.stack([np.array([[i * 20, 0], [i * 20 + 10, 0], [i * 20 + 10, 10], [i * 20, 10]],
                               np.float32) for i in range(6)])
    lines = pipe.group_lines_with_layout_model(quads)
    assert sorted(m for _, ms in lines for m in ms) == list(range(6))
    assert len(lines) == 6  # 4 in-window starts + 2 overflow singletons
    assert pipe.group_lines_with_layout_model(np.zeros((0, 4, 2))) == []


# --------------------------------------------------------------- pipeline

@pytest.fixture(scope="module")
def pipelines():
    """Both pipelines on the same random weights, the layout model at the
    reference's width. Layout seed 20: on ``_doc_quads(3)`` no word's
    probability lies within 1e-4 of the threshold (it reads 3.1e-4), and
    41% of the words are predicted line starts, so lines hold several
    words (seeds 4-19 put a word within 1e-4, or predict only starts or
    only ends)."""
    det_vars = random_variables(JaxDetection(), (1, 64, 64, 1), seed=2)
    rec_vars = random_variables(JaxRecognition(n_classes=97), (1, 64, 32, 1), seed=3)
    lay_vars = layout_variables(jax_layout.LayoutModel(), seed=20)
    jax_pipe = JaxPipeline(det_vars, rec_vars, layout_variables=lay_vars, use_layout_model=True,
                           det_size=DET_SIZE)
    port = OcrPipeline.from_jax_variables(det_vars, rec_vars, lay_vars, use_layout_model=True,
                                          det_size=DET_SIZE, device="cpu")
    return jax_pipe, port, (det_vars, rec_vars, lay_vars)


def _doc_quads(n_pages: int) -> list[np.ndarray]:
    """Word quads of synthetic document pages, shuffled (the pipeline puts
    them in reading order)."""
    ds = layout_synth.SyntheticDocLayout(size=n_pages, n_words=700, seed=11,
                                         normalize_coords=False)
    rng = np.random.default_rng(0)
    out = []
    for i in range(n_pages):
        boxes = ds[i][0]
        boxes = boxes[boxes[:, 2] > boxes[:, 0]]
        boxes = boxes[rng.permutation(len(boxes))]
        l, t, r, b = boxes.T.astype(np.float64)
        out.append(np.stack([np.stack([l, t], 1), np.stack([r, t], 1), np.stack([r, b], 1),
                             np.stack([l, b], 1)], axis=1))
    return out


def test_layout_grouping_matches_jax(pipelines):
    jax_pipe, port, _ = pipelines
    page_quads = _doc_quads(3) + [np.zeros((0, 4, 2))]
    assert max(len(q) for q in page_quads) > port.layout_pad_words  # overflow words too
    padded, pages = port._layout_inputs(page_quads)
    counts = [page[2] for page in pages[:3]]
    assert pages[3] is None and not padded[3].any()
    want_probs = np.asarray(jax_pipe._layout_fwd(jax_pipe._layout_vars, jnp.asarray(padded)))
    with torch.no_grad():
        got_probs = port.layout_model(torch.from_numpy(padded)).numpy()
    np.testing.assert_allclose(got_probs, want_probs, rtol=0, atol=1e-5)
    words = np.concatenate([want_probs[p, :k] for p, k in enumerate(counts)])
    assert np.abs(words - 0.5).min() > 1e-4  # no word's probability near the threshold
    assert (words >= 0.5).any() and (words < 0.5).any()
    want = jax_pipe._group_lines_layout_batch(page_quads)
    got = port._group_lines_layout_batch(page_quads)
    assert len(got) == len(want) == 4 and got[3] == want[3] == []
    for got_page, want_page in zip(got, want):
        assert [m for _, m in got_page] == [m for _, m in want_page]
        for (gb, _), (wb, _) in zip(got_page, want_page):
            np.testing.assert_array_equal(gb, wb)
    single = port.group_lines_with_layout_model(page_quads[0])
    assert [m for _, m in single] == [m for _, m in got[0]]


def _assert_pages_equal(got, want):
    assert len(got) == len(want)
    for got_lines, want_lines in zip(got, want):
        assert [ln.text for ln in got_lines] == [ln.text for ln in want_lines]
        for g, w in zip(got_lines, want_lines):
            np.testing.assert_allclose(g.box, w.box, rtol=0, atol=1e-6)
            assert len(g.words) == len(w.words)
            for gq, wq in zip(g.words, w.words):
                np.testing.assert_array_equal(gq, wq)


def test_pipeline_with_layout_model_matches_jax(pipelines):
    jax_pipe, port, _ = pipelines
    images = [SyntheticDetection(size=1, page_size=(256, 192), seed=s)[0]["image"] for s in (0, 1)]
    want = jax_pipe.run_batch(images, det_batch=2, rec_batch=8)
    got = port.run_batch(images, det_batch=2, rec_batch=8)
    assert sum(len(p) for p in want) > 0
    _assert_pages_equal(got, want)
    _assert_pages_equal([port(images[0])], [jax_pipe(images[0])])


def test_pipeline_from_checkpoints_with_layout(pipelines, tmp_path):
    _, port, _ = pipelines
    paths = {}
    for name, model in (("det", port.det_model), ("rec", port.rec_model),
                        ("layout", port.layout_model)):
        paths[name] = str(tmp_path / f"{name}.pt")
        torch.save({"epoch": 0, "model_state": model.state_dict(), "optimizer_state": {}},
                   paths[name])
    loaded = OcrPipeline.from_checkpoints(paths["det"], paths["rec"], paths["layout"],
                                          use_layout_model=True, det_size=DET_SIZE,
                                          device="cpu")
    assert loaded.use_layout_model and loaded.layout_model is not None
    for key, value in port.layout_model.state_dict().items():
        assert torch.equal(loaded.layout_model.state_dict()[key], value), key
    assert OcrPipeline.from_checkpoints(paths["det"], paths["rec"], device="cpu").layout_model is None


def test_bf16_pipeline_keeps_the_layout_model_in_float32(pipelines):
    _, _, (det_vars, rec_vars, lay_vars) = pipelines
    pipe = OcrPipeline.from_jax_variables(det_vars, rec_vars, lay_vars, use_layout_model=True,
                                          det_size=DET_SIZE, device="cpu",
                                          compute_dtype=torch.bfloat16)
    assert pipe.rec_model.dtype == torch.bfloat16
    assert pipe.layout_model.dtype == torch.float32 and pipe.layout_model.return_probs


def test_use_layout_model_requires_weights():
    with pytest.raises(ValueError, match="layout_state_dict"):
        OcrPipeline(device="cpu", use_layout_model=True)
    with pytest.raises(ValueError, match="layout_variables"):
        JaxPipeline({}, {}, use_layout_model=True)


def test_dropout_patch_for_parity_tests_reaches_the_jax_layers(monkeypatch):
    """The training parity tests take dropout out of the JAX layout model
    through its module's ``nn`` name (the JAX package is not changed):
    check that this makes the JAX train-mode forward its eval forward."""
    patch_jax_dropout(monkeypatch)
    jax_model, variables, _ = _models("sin", jnp.float32, torch.float32)
    boxes = jnp.asarray(_pages(2, 16))
    train = jax_model.apply(variables, boxes, train=True, rngs={"dropout": jax.random.key(0)})
    np.testing.assert_array_equal(np.asarray(train), np.asarray(jax_model.apply(variables, boxes)))
