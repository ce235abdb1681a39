"""An ORBvoc-scale vocabulary (k=10, L=6, ~1.1M words) benchmark (port of
the repository's ``tools/bench_vocab.py``).

Measures what the reference pays in DBoW2 for the real ORBvoc.txt
(slam.cpp:370-380): building a synthetic tree of that shape, writing it
as DBoW2 text, parsing it back (the native C++ parser where its library
loads, then ``load_dbow2_text`` with the tree's assembly), and the batched
tree descent of one frame's 1500 descriptors on the device (median of 20
calls) with its recall under 3 bits of noise per descriptor. The device
holds the tree as {0,1} bytes, 256 per node (~284 MB at depth 6), with
the child table and the word of each node.

    python -m vslam_tpu_torch.tools.bench_vocab [--depth 6] [--json out]
        [--keep voc.txt] [--device cpu]

Runs on the card unless ``--device cpu`` is given (an error where there is
no card). Without ``--keep`` the text file goes to a temporary file that
is removed afterwards. ``parse_native_s`` is recorded only where the
native library loads (``parser`` says which parser ``load_dbow2_text``
used).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def queries(voc, n: int = 1500, flip: float = 3 / 256.0, seed: int = 1):
    """``n`` descriptors near random words (each bit flipped with
    probability ``flip``) and those words."""
    import numpy as np

    rng = np.random.RandomState(seed)
    word_gt = rng.randint(0, voc.num_words, n)
    descs = voc.node_desc[voc.node_of_word[word_gt]].copy()
    descs ^= (rng.rand(n, 256) < flip).astype(np.uint8)
    return descs, word_gt


def bench(depth: int = 6, keep=None, device="cuda"):
    """(record, the vocabulary, the descent's words of ``queries(voc)``
    on the device, as numpy)."""
    import numpy as np
    import torch

    from .. import resolve_device
    from ..io import native
    from ..loop import vocabulary as vocab_mod
    from ..utils.profiling import sync

    dev = resolve_device(device)
    out = {"k": 10, "depth": depth, "words": 10 ** depth}

    t0 = time.perf_counter()
    voc = vocab_mod.synthetic_vocab(k=10, depth=depth, seed=0)
    out["build_s"] = time.perf_counter() - t0
    out["nodes"] = len(voc.parent)
    print(f"build synthetic k=10 L={depth}: {out['build_s']:.2f}s "
          f"({voc.num_words} words, {len(voc.parent)} nodes)", flush=True)

    if keep:
        path = keep
    else:
        fd, path = tempfile.mkstemp(suffix=".txt", prefix="vslam_bench_voc_")
        os.close(fd)
    try:
        t0 = time.perf_counter()
        vocab_mod.save_dbow2_text(voc, path)
        out["save_s"] = time.perf_counter() - t0
        out["file_mb"] = os.path.getsize(path) / 1e6
        print(f"save text: {out['save_s']:.2f}s ({out['file_mb']:.1f} MB)",
              flush=True)

        out["parser"] = "native" if native.available() else "numpy"
        if out["parser"] == "native":
            t0 = time.perf_counter()
            parsed = native.parse_vocab_text(path)
            out["parse_native_s"] = time.perf_counter() - t0
            print(f"parse (native C++): {out['parse_native_s']:.2f}s",
                  flush=True)
            if parsed is None or len(parsed[2]) != len(voc.parent) - 1:
                raise RuntimeError("the native parser read a different tree")

        t0 = time.perf_counter()
        v2 = vocab_mod.load_dbow2_text(path)
        out["parse_full_s"] = time.perf_counter() - t0
        print(f"load_dbow2_text (incl. tree assembly): "
              f"{out['parse_full_s']:.2f}s", flush=True)
        if v2.num_words != voc.num_words:
            raise RuntimeError(f"read back {v2.num_words} words of "
                               f"{voc.num_words}")
    finally:
        if not keep:
            os.unlink(path)

    # descent latency: one frame's worth of descriptors
    descs, word_gt = queries(voc)
    dv = vocab_mod.DeviceVocabulary(voc, dev)
    bits = torch.as_tensor(descs, device=dev)
    valid = torch.ones(len(descs), dtype=torch.bool, device=dev)
    words = dv.words(bits, valid).cpu().numpy()
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        dv.words(bits, valid)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    out["descent_ms_1500"] = times[len(times) // 2]
    out["backend"] = dev.type
    out["device_name"] = (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu")
    out["recall_3bit_noise"] = float(np.mean(words == word_gt))
    print(f"descent 1500 descs ({out['backend']}): "
          f"{out['descent_ms_1500']:.3f} ms, recall "
          f"{out['recall_3bit_noise']:.3f}", flush=True)
    return out, voc, words


def main(argv=None):
    """The command line; returns the record."""
    ap = argparse.ArgumentParser(
        prog="python -m vslam_tpu_torch.tools.bench_vocab",
        description=__doc__.split("\n")[0])
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--keep", type=str, default=None,
                    help="write the vocab text file here and keep it")
    ap.add_argument("--device", default="cuda", help="torch device to run "
                    "on: the card by default (an error without one), 'cpu' "
                    "on request")
    args = ap.parse_args(argv)
    out, _, _ = bench(args.depth, args.keep, args.device)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
