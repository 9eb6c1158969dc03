"""FSDP and sharded checkpoints on one process (ct_clip_ut_tpu_torch/parallel/
sharding.py, train/optimizer.py, train/checkpoint.py); the two-rank runs
are in tests/test_torch_port_parallel.py.

  * the sharded leaves at flagship shapes against JAX's fsdp_param_specs
    (jax.eval_shape of init_ctclip, each leaf's spec carried to the port's
    name through convert.py; nothing allocated): the same set at worlds 2
    and 4 but the VQ codebook, which is buffers in the port;
  * the optimizer on the pieces of a world of 1 against the full optimizer
    (AdamW with the clip active, fp32 and bf16 first moments), with the
    control of a decay mask read from the pieces' ndim;
  * a resume continuing bit for bit, from a sharded directory and from
    the single file of an FSDP state over one rank, and through
    `scripts/train_ctclip.py --fsdp --sharded-checkpoints`; a save cut
    between its two renames read back from `<name>.old`;
  * the refusals: FSDP over more than one process without sharded
    checkpoints (JAX trainer.py:295-304), a mesh on another device, a
    single-file save of pieces no rank holds whole, a clip without the
    whole leaves' norms.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ct_clip_ut_tpu import config as jconfig    # dataclasses only: no JAX
from ct_clip_ut_tpu_torch import convert
from ct_clip_ut_tpu_torch.config import flagship_cfg
from ct_clip_ut_tpu_torch.models.ctclip import CTCLIP, init_ctclip
from ct_clip_ut_tpu_torch.parallel import sharding
from ct_clip_ut_tpu_torch.parallel.mesh import DataMesh
from ct_clip_ut_tpu_torch.train import checkpoint as tckpt
from ct_clip_ut_tpu_torch.train import trainer as ttrainer
from ct_clip_ut_tpu_torch.train.optimizer import get_optimizer

from test_torch_port_data import CFG, TINY_CLIP, fake_dataset_dir  # noqa: F401
from test_torch_port_parallel import FSDP_MIN, FSDP_TRAIN, P_CLIP, _batch
from test_torch_port_train_cli import write_vocab

CPU = torch.device("cpu")
# the leaves JAX shards and the port does not: the VQ codebook's EMA
# tables, buffers in the port (replicated, their statistics summed over
# the ranks as in data parallelism)
JAX_ONLY = {"visual_transformer.vq._codebook.embed", "visual_transformer.vq._codebook.embed_avg"}


def _jax_config(pcfg):
    kw = {f.name: getattr(pcfg, f.name) for f in dataclasses.fields(pcfg)}
    kw = {k: _jax_config(v) if dataclasses.is_dataclass(v) else v for k, v in kw.items()}
    return getattr(jconfig, type(pcfg).__name__)(**kw)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_leaves_are_jax_fsdp_set(world):
    import jax

    from ct_clip_ut_tpu.models.ctclip import init_ctclip as jax_init
    from ct_clip_ut_tpu.parallel.sharding import fsdp_param_specs

    pcfg = flagship_cfg()
    shapes = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), _jax_config(pcfg)))
    specs = fsdp_param_specs(shapes, world)
    # each leaf a one-element marker of its ndim (convert transposes), 1 where JAX shards it
    marks = jax.tree.map(
        lambda leaf, spec: np.full((1,) * len(leaf.shape), float("data" in tuple(spec)),
                                   np.float32),
        shapes, specs, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    sd = {}
    convert._bert(sd, "text_transformer", marks["text_transformer"])
    convert._ctvit(sd, "visual_transformer", marks["visual_transformer"])
    for name in ("to_text_latent", "to_visual_latent"):
        convert._linear(sd, name, marks[name])
    jax_set = {k for k, v in sd.items() if float(v.reshape(-1)[0]) == 1.0}
    with torch.device("meta"):
        model = CTCLIP(pcfg)
    port_set = {n for n, p in model.named_parameters() if sharding.fsdp_sharded(p.shape)}
    assert len(port_set) == 118
    assert jax_set - port_set == JAX_ONLY and port_set <= jax_set
    assert JAX_ONLY <= {n for n, _ in model.named_buffers()}


def test_chunk_spans_are_torch_chunks():
    """A piece is torch.chunk's (and DTensor Shard(0)'s), empty past the
    chunks: 5 elements over 4 ranks are 2, 2, 1, 0."""
    flat = torch.arange(5.0)
    spans = [sharding.chunk_span(5, 4, r) for r in range(4)]
    assert spans == [(0, 2), (2, 4), (4, 5), (5, 5)]
    for (lo, hi), piece in zip(spans, torch.chunk(flat, 4)):
        assert torch.equal(flat[lo:hi], piece)


def _leaves(seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.nn.Parameter(torch.randn(shape, generator=g))
            for shape in ((24, 16), (16,), (3, 8, 4), (40,), ())]


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_optimizer_on_pieces_matches_the_full_optimizer(mu_dtype, monkeypatch):
    """AdamW (wd > 0, the clip active) over the pieces of a world of 1
    (every leaf of 20 elements and up sharded: its one piece 1-D) against
    the same optimizer over the full leaves: three steps the same bits,
    state_dict per piece; the control, a decay mask read from the pieces'
    ndim, decays no matrix and moves off the full optimizer."""
    monkeypatch.setattr(sharding, "_FSDP_MIN_SIZE", 20)

    def run(sharded, control=False):
        params = _leaves()
        opt = get_optimizer(params, lr=1e-2, wd=0.1, max_grad_norm=0.5, mu_dtype=mu_dtype)
        layout = None
        if sharded:
            layout = sharding.layout_of(params, DataMesh(1, 0, CPU))
            layout.pieces = [None if s is None else layout.piece_of(i, p)
                             for i, (p, s) in enumerate(zip(params, layout.spans))]
            opt.shard(layout)
            if control:
                opt.decayed = [i for i, p in enumerate(opt.params) if p.ndim >= 2]
        g = torch.Generator().manual_seed(1)
        norms = []
        for _ in range(3):
            for leaf, p in zip(opt.params, params):
                leaf.grad = torch.randn(p.shape, generator=g).reshape(leaf.shape)
            norms.append(opt.step())
        return [p.detach().reshape(-1) for p in opt.params], opt.state_dict(), norms, layout

    full, full_sd, full_norms, _ = run(False)
    got, got_sd, got_norms, layout = run(True)
    assert layout.sharded == [True, False, True, True, False]
    assert [t.ndim for t in got] == [1] * 5
    for a, b in zip(got, full):
        assert torch.equal(a, b)
    assert torch.equal(torch.stack(got_norms), torch.stack(full_norms))
    assert full_norms[0] > 0.5
    for key in ("mu", "nu"):
        for a, b in zip(got_sd[key], full_sd[key]):
            assert torch.equal(a.reshape(-1), b.reshape(-1))
    assert got_sd["mu"][0].ndim == 1 and got_sd["count"] == full_sd["count"] == 3
    control = run(True, control=True)[0]
    assert not torch.equal(control[0], full[0]) and torch.equal(control[1], full[1])


def _fsdp_state(init):
    model = init_ctclip(P_CLIP, seed=0, device="cpu")
    model.load_state_dict(init)
    return ttrainer.create_train_state(P_CLIP, FSDP_TRAIN, params=model.requires_grad_(True),
                                       device="cpu")


def _steps(state, seeds):
    step = ttrainer.make_train_step(P_CLIP, FSDP_TRAIN)
    losses = []
    for seed in seeds:
        images, text = _batch(seed=seed)
        losses.append(step(state, torch.from_numpy(images),
                           {k: torch.from_numpy(v) for k, v in text.items()}).item())
    return losses


@pytest.mark.parametrize("sharded", [True, False])
def test_sharded_checkpoint_resume_continues_bit_for_bit(sharded, tmp_path, monkeypatch):
    """Three FSDP steps straight against two, a save, a load into a fresh
    state and the third step: the same loss, pieces, moments, step, count
    and generator; between steps the sharded parameters hold no storage.
    The sharded directory is replaced by a second save, no .tmp or .old
    left; the single file of an FSDP state over one rank holds its pieces
    whole."""
    monkeypatch.setattr(sharding, "_FSDP_MIN_SIZE", FSDP_MIN)
    init = init_ctclip(P_CLIP, seed=3, device="cpu").state_dict()
    straight = _fsdp_state(init)
    want = _steps(straight, (41, 42, 43))
    first = _fsdp_state(init)
    _steps(first, (41, 42))
    resumed = _fsdp_state(init_ctclip(P_CLIP, seed=9, device="cpu").state_dict())
    if sharded:
        tckpt.save_checkpoint_sharded(tmp_path / "last.dcp", first)
        tckpt.save_checkpoint_sharded(tmp_path / "last.dcp", first)
        assert sorted(p.name for p in tmp_path.iterdir()) == ["last.dcp"]
        tckpt.load_checkpoint_sharded(tmp_path / "last.dcp", resumed)
    else:
        tckpt.save_checkpoint(tmp_path / "last.pt", first)
        blob = torch.load(tmp_path / "last.pt", weights_only=True)
        assert blob["model"]["to_visual_latent.weight"].shape == (8, 256)
        tckpt.load_checkpoint(tmp_path / "last.pt", resumed, blob=blob)
    assert (resumed.step, resumed.optimizer.count) == (2, 2)
    assert _steps(resumed, (43,)) == want[2:]
    for a, b in zip(resumed.optimizer.params + resumed.optimizer.mu + resumed.optimizer.nu,
                    straight.optimizer.params + straight.optimizer.mu + straight.optimizer.nu):
        assert torch.equal(a, b)
    assert torch.equal(resumed.generator.get_state(), straight.generator.get_state())
    layout = resumed.fsdp
    assert sum(layout.sharded) == 38
    assert all(p.numel() == 0 and p.grad is None
               for p, s in zip(layout.params, layout.spans) if s is not None)


def test_cut_sharded_save_reads_the_old_directory(tmp_path, monkeypatch):
    """A save cut between its two renames leaves the previous checkpoint
    as `<name>.old` alone: the load reads it, with its bits, and the next
    save replaces it, leaving only `<name>`. A file or nothing at the path
    is no sharded directory."""
    monkeypatch.setattr(sharding, "_FSDP_MIN_SIZE", FSDP_MIN)
    init = init_ctclip(P_CLIP, seed=3, device="cpu").state_dict()
    first = _fsdp_state(init)
    _steps(first, (41,))
    path = tmp_path / "last.dcp"
    tckpt.save_checkpoint_sharded(path, first)
    saved = [t.clone() for t in first.optimizer.params + first.optimizer.mu + first.optimizer.nu]
    _steps(first, (42,))
    path.rename(tmp_path / "last.dcp.old")          # the cut: the new one never renamed in
    (tmp_path / "last.dcp.tmp").mkdir()
    assert tckpt.sharded_dir(path) == tmp_path / "last.dcp.old"
    resumed = _fsdp_state(init_ctclip(P_CLIP, seed=9, device="cpu").state_dict())
    tckpt.load_checkpoint_sharded(path, resumed)
    assert (resumed.step, resumed.optimizer.count) == (1, 1)
    got = resumed.optimizer.params + resumed.optimizer.mu + resumed.optimizer.nu
    assert all(torch.equal(a, b) for a, b in zip(got, saved))
    tckpt.save_checkpoint_sharded(path, first)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["last.dcp"]
    assert tckpt.sharded_dir(path) == path
    (tmp_path / "last.pt").write_bytes(b"")
    assert tckpt.sharded_dir(tmp_path / "last.pt") is None
    assert tckpt.sharded_dir(tmp_path / "none.dcp") is None
    with pytest.raises(FileNotFoundError, match="no sharded checkpoint"):
        tckpt.load_checkpoint_sharded(tmp_path / "none.dcp", resumed)


def test_fsdp_refusals(tmp_path):
    """FSDP over two processes without sharded checkpoints raises up front;
    so do a mesh on another device than the parameters', a single-file
    save of an FSDP state over two ranks (no rank holds a leaf whole) and
    its optimizer's step without the whole leaves' norms."""
    with pytest.raises(ValueError, match="sharded_checkpoints=True"):
        ttrainer.CTClipTrainer(P_CLIP, dataclasses.replace(FSDP_TRAIN, sharded_checkpoints=False),
                               None, [], [], results_folder=str(tmp_path),
                               mesh=DataMesh(2, 0, CPU), device="cpu")
    model = init_ctclip(P_CLIP, seed=0, device="cpu")
    with pytest.raises(ValueError, match="a mesh on meta"):
        sharding.shard_state(model, None, DataMesh(1, 0, torch.device("meta")))
    state = ttrainer.create_train_state(P_CLIP, dataclasses.replace(FSDP_TRAIN, fsdp=False),
                                        params=model, device="cpu")
    state.fsdp = sharding.shard_state(state.model, state.optimizer, DataMesh(2, 0, CPU))
    with pytest.raises(ValueError, match="no rank holds it whole"):
        tckpt.save_checkpoint(tmp_path / "x.pt", state)
    with pytest.raises(ValueError, match="give no leaf's norm"):
        state.optimizer.step()


def test_train_cli_fsdp_sharded_checkpoints_resume(fake_dataset_dir, tmp_path,  # noqa: F811
                                                   monkeypatch):
    """scripts/train_ctclip --fsdp --sharded-checkpoints: two epochs
    straight against one epoch, then a second resumed from its
    last_checkpoint.dcp directory: the same step and epoch loss bits, the
    parameters within 1e-6 of each tensor's largest entry (two straight
    runs of the CLI on the CPU already differ in the token-type
    embedding's gradient, ~1e-9: the threaded embedding backward sums in
    no fixed order; the state's resume is held bit for bit above)."""
    from ct_clip_ut_tpu_torch.scripts import train_ctclip as cli

    monkeypatch.setattr(sharding, "_FSDP_MIN_SIZE", FSDP_MIN)
    d = fake_dataset_dir
    argv = ["--data-train", str(d / "volumes"), "--data-valid", str(d / "volumes"),
            "--train-reports", str(d / "reports.csv"), "--valid-reports", str(d / "reports.csv"),
            "--valid-labels", str(d / "labels.csv"), "--train-metadata", str(d / "metadata.csv"),
            "--valid-metadata", str(d / "metadata.csv"), "--tokenizer",
            str(write_vocab(tmp_path / "tok")), "--batch-size", "2", "--num-train-samples", "4",
            "--num-valid-samples", "2", "--num-workers", "1", "--save-every-steps", "2",
            "--lr", "1e-3", "--fsdp", "--sharded-checkpoints", "--device", "cpu"]
    straight = cli.main(argv + ["--num-epochs", "2", "--results-folder", str(tmp_path / "a")],
                        model_cfg=TINY_CLIP, preprocess_cfg=CFG)
    first = cli.main(argv + ["--num-epochs", "1", "--results-folder", str(tmp_path / "b")],
                     model_cfg=TINY_CLIP, preprocess_cfg=CFG)
    last = first.results_folder / "last_checkpoint.dcp"
    assert last.is_dir() and (first.results_folder / "best_checkpoint.dcp").is_dir()
    again = cli.main(argv + ["--num-epochs", "2", "--checkpoint", str(last), "--results-folder",
                             str(tmp_path / "c")], model_cfg=TINY_CLIP, preprocess_cfg=CFG)
    assert again.state.step == straight.state.step == 4
    assert again.train_losses["epochs"] == straight.train_losses["epochs"][-1:]
    assert again.state.fsdp is not None
    for a, b in zip(again.state.optimizer.params, straight.state.optimizer.params):
        assert not b.numel() or float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
