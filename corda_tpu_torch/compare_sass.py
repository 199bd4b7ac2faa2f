"""Compare the machine code of the kernels built from two csrc/ trees.

    python3 -m corda_tpu_torch.compare_sass OLD_CSRC [NEW_CSRC [SOURCE ...]]

Builds each named ``.cu`` source (by default every one that both trees
have) from both trees with nvcc into a cubin for sm_90a, with the flags of
``ops/_build.py``, and prints for each source the md5 of both cubins and
the number of lines of either ``cuobjdump -sass`` listing that the other
lacks; where the cubins differ, it also says for each kernel of the
source whether its own listing is identical, and for a kernel in both
whose listing differs, the first lines that only one side has. It exits
1 when any cubin
differs. It needs the CUDA toolkit, not a card. NEW_CSRC defaults to this
package's csrc/.

Use it to show that a change to a shared header leaves a kernel's code as
it was: unpack the parent commit with ``git archive`` into a directory
that .gitignore lists and pass its csrc/ as OLD_CSRC.
"""

from __future__ import annotations

import hashlib
import shutil
import subprocess
import sys
import tempfile
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from .ops import _build

SHOWN = 4   # lines shown from each side of a kernel whose listing differs


def _cubin(nvcc: str, csrc: Path, source: str, out: Path) -> bytes:
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I", str(csrc), "-cubin",
                    str(csrc / source), "-o", str(out)],
                   check=True, capture_output=True, text=True)
    return out.read_bytes()


def _sass(cuobjdump: str, cubin: Path) -> list[str]:
    text = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    # whitespace collapsed: cuobjdump pads its columns to the widest
    # instruction in the file, so an unchanged kernel's lines change width
    # when another kernel of the source changes
    return [" ".join(line.split()) for line in text.splitlines()
            if line.strip() and str(cubin.name) not in line]


def _functions(listing: list[str]) -> dict[str, list[str]]:
    """A SASS listing cut at each ``Function :`` header: {kernel: lines}."""
    out: dict[str, list[str]] = {}
    name = None
    for line in listing:
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return out


def compare(old: Path, new: Path, sources: list[str]) -> bool:
    """Print one line per source; True iff every pair of cubins is equal."""
    nvcc = _build._nvcc()
    cuobjdump = shutil.which("cuobjdump") or str(Path(nvcc).with_name("cuobjdump"))
    same = True
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(side, tree, src) for src in sources
                for side, tree in (("old", old), ("new", new))]
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            futs = {(side, src): pool.submit(_cubin, nvcc, tree, src,
                                             Path(tmp) / f"{side}.{src}.cubin")
                    for side, tree, src in jobs}
            bins = {k: f.result() for k, f in futs.items()}
        for src in sources:
            listings = [_sass(cuobjdump, Path(tmp) / f"{side}.{src}.cubin")
                        for side in ("old", "new")]
            # lines of either listing without a match in the other (a
            # multiset difference: linear, where a full diff of two long
            # and different listings takes minutes)
            old_lines, new_lines = Counter(listings[0]), Counter(listings[1])
            differing = sum(((old_lines - new_lines) + (new_lines - old_lines)).values())
            digests = [hashlib.md5(bins[(side, src)]).hexdigest()[:12]
                       for side in ("old", "new")]
            equal = bins[("old", src)] == bins[("new", src)]
            same &= equal
            print(f"{src}: cubin md5 {digests[0]} / {digests[1]} "
                  f"({'identical' if equal else 'DIFFERENT'}); SASS lines "
                  f"{len(listings[0])} / {len(listings[1])}, {differing} differing")
            if not equal:
                funcs = [_functions(listing) for listing in listings]
                for name in sorted(funcs[0].keys() | funcs[1].keys()):
                    a, b = funcs[0].get(name), funcs[1].get(name)
                    verdict = ("only in " + ("new" if a is None else "old")) if a is None or \
                        b is None else ("identical" if a == b else "differs")
                    print(f"  {name}: SASS {verdict}")
                    if verdict == "differs":
                        ca, cb = Counter(a), Counter(b)
                        for side, lines in (("old", ca - cb), ("new", cb - ca)):
                            for line in list(lines.elements())[:SHOWN]:
                                print(f"    only {side}: {line}")
    return same


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    old = Path(argv[0])
    new = Path(argv[1]) if len(argv) > 1 else _build.CSRC
    sources = argv[2:] or sorted(p.name for p in new.glob("*.cu") if (old / p.name).exists())
    return 0 if compare(old, new, sources) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
