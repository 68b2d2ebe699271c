"""First-use builds of the package's native code.

Shared libraries go to `build/` beside the package (gitignored), named
by a hash of their sources and flags, so a changed source rebuilds and
concurrent processes never load a half-written file: each compiles to
a private temporary name and renames it into place.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from typing import Sequence

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
)


def build_shared(name: str, sources: Sequence[str],
                 commands: Sequence[Sequence[str]],
                 deps: Sequence[str] = ()) -> str:
    """Compile `sources` into build/lib<name>-<hash>.so unless it exists.

    `deps` are headers the sources include: they join the hash, not the
    command line.  `commands` are alternative compiler command lines,
    tried in order;
    each is completed with the sources and `-o <output>`.  Returns the
    library's path; raises RuntimeError with the compiler's messages
    when every command fails."""
    h = hashlib.sha256()
    for src in [*sources, *deps]:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(repr([list(c) for c in commands]).encode())
    path = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    errors = []
    for cmd in commands:
        res = subprocess.run(
            [*cmd, *sources, "-o", tmp], capture_output=True, text=True
        )
        if res.returncode == 0:
            os.replace(tmp, path)
            return path
        errors.append(f"$ {' '.join(cmd)}\n{res.stderr}")
    raise RuntimeError(f"building {name} failed:\n" + "\n".join(errors))
