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


def build_locked(target: str, sources: List[str],
                 command: Callable[[str], List[str]]) -> Optional[str]:
    """Run ``command(tmp_path)`` to (re)build ``target`` if it is stale.
    Returns the compiler's combined output when a build ran, else None;
    raises RuntimeError when the build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale(target, sources):
            return None
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = command(tmp)
        try:
            r = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"build of {target} failed: {e}") from e
        if r.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"build of {target} failed ({' '.join(cmd)}):\n"
                f"{r.stdout}{r.stderr}")
        os.replace(tmp, target)
        return r.stdout + r.stderr
