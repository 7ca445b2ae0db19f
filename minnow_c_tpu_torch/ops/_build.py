"""Build-at-first-use for the package's native libraries.

Each library is compiled into ``minnow_c_tpu_torch/_build/`` (git-ignored)
when it is missing or older than one of its sources.  An exclusive file
lock serialises concurrent builds (several test workers importing the
package at once), and the library is written under a temporary name and
renamed into place, so a reader never loads a half-written file.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
from typing import Callable, List, Optional

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")


def _stale(target: str, sources: List[str]) -> bool:
    if not os.path.exists(target):
        return True
    t = os.path.getmtime(target)
    return any(os.path.getmtime(s) > t for s in sources)


def run_all(commands: List[List[str]]) -> str:
    """Start every command at once, each in its own process, and wait for
    all of them.  Returns their combined output; raises RuntimeError
    naming the first command that failed."""
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in commands]
    except OSError as e:
        raise RuntimeError(f"build failed: {e}") from e
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(commands, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"build failed ({' '.join(cmd)}):\n{out}")
    return "".join(outs)


def build_locked(target: str, sources: List[str],
                 build: Callable[[str], str]) -> Optional[str]:
    """Run ``build(tmp_path)`` to (re)build ``target`` if it is stale;
    ``build`` writes the library to ``tmp_path`` and returns the compiler's
    output.  Returns that output when a build ran, else None; raises
    RuntimeError when the build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale(target, sources):
            return None
        tmp = f"{target}.{os.getpid()}.tmp"
        try:
            log = build(tmp)
        except RuntimeError:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        os.replace(tmp, target)
        return log
