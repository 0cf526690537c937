#!/usr/bin/env python3
"""K14 (Morgan) at the main path's chunks on one NVIDIA GPU.

    python3 tools/k14_chunk_timing.py

Featurizes ``chip_smoke.py``'s 24,500 SMILES and cuts them into the chunks
``GetFingerprintsFromSmiles`` launches K14 on (r=3, 2048 bits). Holds each
chunk's fingerprints to the plain version bit for bit, then prints the
CUDA-event median of the five launches back to back and of each chunk
alone (hot L2), with the layout K14 takes for it. The card's name and power
limit first.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k14_chunk_timing: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from nvmolkit_tpu_torch import fingerprints as fp_api
    from nvmolkit_tpu_torch.chem.native import morgan_batches_from_smiles
    from nvmolkit_tpu_torch.ops import morgan
    from nvmolkit_tpu_torch.utils.config import HardwareOptions

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, timeout=60).stdout.strip())
    cuda = torch.device("cuda", 0)
    inputs = morgan_batches_from_smiles(smoke.smoke_smiles(), HardwareOptions().atomBuckets)
    chunks = [[torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(cuda)
               for a in (arrays[k][s:s + fp_api._chunk_rows(b)] for k in fp_api._KERNEL_INPUTS)]
              for b, (idx, arrays) in sorted(inputs.items())
              for s in range(0, len(idx), fp_api._chunk_rows(b))]
    for args in chunks:
        got = morgan.morgan_kernel(*args, radius=3, fp_size=2048)
        if not torch.equal(got, morgan.morgan_kernel_plain(*args, radius=3, fp_size=2048)):
            print(f"K14 differs from plain at {tuple(args[0].shape)}", file=sys.stderr)
            return 1

    def all_chunks():
        for args in chunks:
            morgan.morgan_kernel(*args, radius=3, fp_size=2048)

    print("all chunks ms", smoke.median_ms(all_chunks, 20))
    for args in chunks:
        ms = smoke.median_ms(lambda a=args: morgan.morgan_kernel(*a, radius=3, fp_size=2048), 20)
        layout = morgan.kernel_layout(args[0].shape[1], args[4].shape[2], 3, 2048)
        print("chunk", tuple(args[0].shape), layout, "ms", ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
