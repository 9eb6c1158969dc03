"""The port's train CLI (scripts/train_ctclip.py) and GradCache
(train/trainer.py `make_train_step_gradcache`), on the CPU.

The CLI: its parser against the JAX script's `build_parser`, flag for flag
with the same defaults (and --device); its refusals, each naming its
ROADMAP item; `main` over tests/test_torch_port_data.py's synthetic NIfTI
volumes and CSVs with a WordPiece vocabulary, two GradCache steps, then a
resume from the run's last_checkpoint.pt.

GradCache (trainer.py:116-251 of the JAX package): the full batch's InfoNCE
objective from microbatches. At dropout 0, k = 2 and 4 microbatches of a
batch of 4 against the port's single-pass step from the same state, two
steps: the losses within 1e-6 relative, the updates and the VQ state
within the bands the fp32 steps are held to against JAX
(tests/test_torch_port_train.py); k = 2 against the JAX package's GradCache
step in those bands. In train mode (dropout 0.1 at BERT's sites), each
microbatch's latents of pass 2 are pass 1's, bit for bit: the generator's
state is restored before each microbatch's pass 2. Two gloo ranks: in
tests/test_torch_port_parallel.py.
"""

import numpy as np
import pytest
import torch

from ct_clip_ut_tpu.scripts import train_ctclip as jcli   # argparse only: no JAX
from ct_clip_ut_tpu_torch.config import TrainConfig, replace
from ct_clip_ut_tpu_torch.scripts import train_ctclip as cli
from ct_clip_ut_tpu_torch.train import trainer as ttrainer

from test_torch_port_data import CFG, TINY_CLIP, fake_dataset_dir  # noqa: F401
from test_torch_port_modules import port_config
from test_torch_port_train import (SHIFT_INVARIANT, TEXT_LEN, TRAIN_CLIP, _batch,
                                   _run_three_steps, check_fp32_steps)

BASE = ["--data-train", "/d/t", "--data-valid", "/d/v", "--train-reports", "t.csv",
        "--valid-reports", "v.csv", "--valid-labels", "l.csv", "--train-metadata", "tm.csv",
        "--valid-metadata", "vm.csv"]
WORDS = ("lungs are clear no effusion present noted mild opacity ok none small nodule "
         "x y report").split()


def _flags(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.required, a.type, a.nargs)
            for a in parser._actions if a.dest != "help"}


def test_train_parser_matches_jax_flags():
    got, want = _flags(cli.build_parser()), _flags(jcli.build_parser())
    assert got.pop("device")[1] == "cuda"
    assert got == want
    args = cli.build_parser().parse_args(BASE + ["--grad-accum", "4", "--batch-size", "8"])
    assert (args.grad_accum, args.batch_size, args.tokenizer) == (
        4, 8, "microsoft/BiomedVLP-CXR-BERT-specialized")


@pytest.mark.parametrize("extra,error,match", [
    (["--batch-size", "3", "--grad-accum", "2"], SystemExit, None),
    (["--grad-accum", "0"], SystemExit, None),
    (["--moe-experts", "2"], NotImplementedError, "item 11h"),
    (["--mesh-model", "2"], NotImplementedError, "item 11c"),
    (["--tokenizer", "no/such/dir"], FileNotFoundError, "vocab.txt")])
def test_train_cli_refusals(extra, error, match):
    """The JAX script's parser.error on --grad-accum; what the port does not
    run raises with its ROADMAP item before any data or weights load; a
    tokenizer directory without vocab.txt raises naming it."""
    with pytest.raises(error, match=match):
        cli.main(BASE + ["--device", "cpu"] + extra)


def write_vocab(path, words=WORDS):
    """A WordPiece vocab.txt: the special tokens, punctuation, `words`
    and a few continuation pieces."""
    path.mkdir(parents=True, exist_ok=True)
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ".", ",", "(", ")", "'", '"', "-",
              *words, "##s", "##ed", "##al"]
    (path / "vocab.txt").write_text("\n".join(tokens) + "\n")
    return path


def test_train_cli_trains_with_gradcache_and_resumes(fake_dataset_dir, tmp_path):  # noqa: F811
    """Two GradCache steps of the tiny model over 4 volumes (batch 2 in 2
    microbatches, bf16 as the CLI trains), a validation pass and
    last_checkpoint.pt; then a second epoch resumed from it (steps 3 and
    4, no step-0 evaluation)."""
    d = fake_dataset_dir
    argv = ["--data-train", str(d / "volumes"), "--data-valid", str(d / "volumes"),
            "--train-reports", str(d / "reports.csv"), "--valid-reports", str(d / "reports.csv"),
            "--valid-labels", str(d / "labels.csv"), "--train-metadata", str(d / "metadata.csv"),
            "--valid-metadata", str(d / "metadata.csv"), "--tokenizer",
            str(write_vocab(tmp_path / "tok")), "--batch-size", "2", "--grad-accum", "2",
            "--num-epochs", "1", "--num-train-samples", "4", "--num-valid-samples", "2",
            "--num-workers", "2", "--save-every-steps", "2", "--lr", "1e-3",
            "--results-folder", str(tmp_path / "run"), "--device", "cpu"]
    tr = cli.main(argv, model_cfg=TINY_CLIP, preprocess_cfg=CFG)
    assert tr.state.step == 2 and tr.cfg.grad_accum == 2
    assert len(tr.train_losses["epochs"]) == 2 and np.isfinite(tr.train_losses["epochs"]).all()
    last = tr.results_folder / "last_checkpoint.pt"
    assert last.exists() and len(tr.valid_losses) == 2
    i = argv.index("--num-epochs")
    again = cli.main(argv[:i] + ["--num-epochs", "2", "--checkpoint", str(last)] + argv[i + 2:],
                     model_cfg=TINY_CLIP, preprocess_cfg=CFG)
    assert again.state.step == 4 and len(again.train_losses["epochs"]) == 1
    assert np.isfinite(again.valid_losses).all() and len(again.valid_losses) == 1


def _steps(k, b=4, steps=2, cfg=TRAIN_CLIP):
    """`steps` steps of the port's step from one state, batch b in k
    microbatches (k = 1: the single-pass step); (losses, state dict before,
    state dict after)."""
    tcfg = TrainConfig(lr=1e-3, compute_dtype="float32", text_max_length=TEXT_LEN,
                       grad_accum=k, seed=3)
    state = ttrainer.create_train_state(port_config(cfg), tcfg, device="cpu")
    before = {n: v.clone() for n, v in state.model.state_dict().items()}
    step = ttrainer.make_train_step(port_config(cfg), tcfg)
    losses = []
    for i in range(steps):
        images, text = _batch(40 + i, b)
        losses.append(step(state, torch.from_numpy(images),
                           {n: torch.from_numpy(v) for n, v in text.items()}).item())
    return losses, before, state.model.state_dict()


@pytest.mark.parametrize("k", [2, 4])
def test_gradcache_matches_the_single_pass_step(k):
    losses, before, want = _steps(1)
    got_losses, _, got = _steps(k)
    np.testing.assert_allclose(got_losses, losses, rtol=1e-6)
    upd = {n: (got[n] - before[n], want[n] - before[n]) for n in before
           if ".vq." not in n and n not in SHIFT_INVARIANT and got[n].is_floating_point()}
    check_fp32_steps(list(zip(got_losses, losses)), upd, got, want)


def test_gradcache_matches_jax_gradcache():
    check_fp32_steps(*_run_three_steps("float32", grad_accum=2, b=2, steps=2))


def test_gradcache_pass_two_replays_pass_one_dropout():
    """Train mode at BERT's dropout 0.1: pass 2's latents are pass 1's bit
    for bit in every microbatch, and the text latents are not those of the
    same weights at dropout 0 (the masks acted)."""
    clip = port_config(replace(TRAIN_CLIP, bert=replace(TRAIN_CLIP.bert, hidden_dropout=0.1,
                                                        attention_dropout=0.1)))
    tcfg = TrainConfig(lr=1e-3, compute_dtype="float32", text_max_length=TEXT_LEN,
                       grad_accum=2, seed=3)
    state = ttrainer.create_train_state(clip, tcfg, device="cpu")
    record = {}
    step = ttrainer.make_train_step_gradcache(clip, tcfg, record=record)
    images, text = _batch(40, 4)
    step(state, torch.from_numpy(images), {n: torch.from_numpy(v) for n, v in text.items()})
    assert len(record["pass1"]) == len(record["pass2"]) == 2
    for (i1, t1), (i2, t2) in zip(record["pass1"], record["pass2"]):
        assert torch.equal(i1, i2) and torch.equal(t1, t2)
    det = ttrainer.create_train_state(port_config(TRAIN_CLIP), tcfg, device="cpu")
    det_record = {}
    ttrainer.make_train_step_gradcache(port_config(TRAIN_CLIP), tcfg, record=det_record)(
        det, torch.from_numpy(images), {n: torch.from_numpy(v) for n, v in text.items()})
    assert not torch.equal(record["pass1"][0][1], det_record["pass1"][0][1])
