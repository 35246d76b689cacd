"""Measure the encdec and vlm families' and their server's and trainer's
differences from the reference.

    PYTHONPATH=src python tests/_multimodal_measure.py [parts | launch]

Runs the reference sides of tests/test_torch_multimodal.py and
tests/test_torch_multimodal_launch.py (their worker subprocesses) and the
port's counterparts on the CPU, and prints what the tests bound: per model
the logits' difference in bf16 ulps of the largest logit (with the vlm's
gates set), beside the wrong runs' (cross-attention zeroed, encoder output
zeroed); the loss's relative difference, beside the cross-entropy of the
reference's own logits; the gradients' in bf16 ulps of each leaf's
largest entry; the cross-attention outputs' and the decode step's in
ulps; then the trainer's losses and final-parameter drift beside the run
that dropped one step's update, and the share of the server's greedy
tokens equal to the reference's.  The tests' bounds were set from this
script's output.  It takes a few minutes.
"""
import contextlib
import io
import sys
import tempfile
from pathlib import Path

import numpy as np


def _parts(tmp):
    import pytest
    import torch

    import test_torch_multimodal as tm
    from repro_torch.models import layers as L

    spec, arrays = tm.reference_spec()
    ref = tm.start_reference(Path(tmp), "multimodal_parts", spec, arrays,
                             timeout=1800)()
    for arch in tm.ARCHS:
        _, params = tm.case_params(arch)
        bx, by, feats = tm.batch_arrays(arch)
        logits, loss, grads = tm.readings(arch, params, bx, by, feats)
        want = ref[f"{arch}/logits"]
        ce = float(L.cross_entropy(torch.from_numpy(want),
                                   torch.from_numpy(by),
                                   vocab_size=tm.get_smoke(arch).vocab_size))
        rl = float(ref[f"{arch}/loss"])
        ulps = {p: float(np.abs(v - ref[f"{arch}/grad/{p}"]).max()
                         / tm.bf16_ulp(np.abs(ref[f"{arch}/grad/{p}"]).max()))
                for p, v in grads.items()}
        g = max(u for p, u in ulps.items() if p not in tm.GATE_LEAVES)
        gates = {p: float(np.abs(grads[p] - ref[f"{arch}/grad/{p}"]).max()
                          / np.abs(ref[f"{arch}/grad/{p}"]).max())
                 for p in tm.GATE_LEAVES if p in grads}
        print(f"{arch}: logits {tm.logit_ulps(logits, want):.3g} ulps "
              f"(equal share {(logits == want).mean():.3f}); loss rel "
              f"{abs(loss - rl) / abs(rl):.3g} (the CE of the reference's "
              f"logits against its loss: {abs(ce - rl) / abs(rl):.3g}; the "
              f"port's against that CE {abs(loss - ce) / abs(ce):.3g}); "
              f"grads worst {g:.3g} ulps but the gates'; the gates "
              f"relative {gates} (F5)")
        mp = pytest.MonkeyPatch()
        try:
            cfg = tm.get_smoke(arch)
            batch = {"tokens": torch.from_numpy(bx), **tm.modal(arch, feats)}
            with torch.no_grad():
                if cfg.family == "encdec":
                    enc = tm.encdec.encode(params, batch["enc_feats"], cfg)
                    wrong = tm.encdec.forward(
                        params, batch["tokens"], cfg,
                        enc_out=torch.zeros_like(enc))[0]
                else:
                    tm.zeroed_cross_attention(mp)
                    wrong = tm.vlm.forward(params, batch["tokens"], cfg,
                                           img_feats=batch["img_feats"])[0]
        finally:
            mp.undo()
        print(f"  wrong run (memory zeroed): logits "
              f"{tm.logit_ulps(wrong.numpy(), want):.3g} ulps")
        toks, dfeats = tm.decode_arrays(arch)
        full, step = tm.decode(arch, params, toks, dfeats)
        print(f"  decode step against the reference's step "
              f"{tm.logit_ulps(step, ref[f'dec/{arch}/step']):.3g} ulps; "
              f"against the full forward "
              f"{float(np.abs(step[:, 0] - full[:, -1]).max()):.3g}")
    for key, (arch, _, _, chunk) in tm.XATTN_CASES.items():
        x, src, p = tm.xattn_arrays(key)
        y, _ = L.attention_block(
            {k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(x), tm.get_smoke(arch),
            mask_spec=L.AttnMaskSpec(), kv_source=torch.from_numpy(src),
            kv_chunk=chunk)
        print(f"xattn {key}: {tm.logit_ulps(y.float().numpy(), ref[f'xattn/{key}/out']):.3g} ulps")


def _launch(tmp):
    import torch

    import test_torch_multimodal_launch as tl

    class Factory:
        def mktemp(self, name):
            path = Path(tmp) / name
            path.mkdir(parents=True)
            return path

    ckpt = Path(tmp) / "ckpt"
    ckpt.mkdir()
    ref = tl.start_job(Factory(), ckpt)()
    for run, (argv, gates, limit) in tl.TRAIN_RUNS.items():
        path = ckpt / f"port_{run}.ckpt"
        losses = np.asarray(tl.run_train(argv + ["--save", str(path)],
                                         gates=gates))
        want = ref[f"train/{run}"]
        drifts = tl.mean_drifts(path, ckpt / f"ref_{run}.ckpt")
        wrong_path = ckpt / f"wrong_{run}.ckpt"
        tl.run_train(argv + ["--save", str(wrong_path)], gates=gates, drop=3)
        wrong = tl.mean_drifts(wrong_path, ckpt / f"ref_{run}.ckpt")
        print(f"train {run}: losses rel {np.abs(losses - want).max() / np.abs(want).min():.3g}; "
              f"worst leaf mean drift {max(drifts.values()):.3g} (limit "
              f"{limit}); dropped step 3: {max(wrong.values()):.3g}")
    for key, (argv, gates) in tl.SERVE_RUNS.items():
        with contextlib.redirect_stdout(io.StringIO()):
            gen = tl.run_serve(argv, gates)
        print(f"serve {key}: equal share "
              f"{(gen.numpy() == ref[f'serve/{key}']).mean():.3f}")


def main(argv) -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch

    torch.set_num_threads(4)
    what = argv[1] if len(argv) > 1 else ""
    with tempfile.TemporaryDirectory() as tmp:
        if what in ("", "parts"):
            _parts(tmp)
        if what in ("", "launch"):
            _launch(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
