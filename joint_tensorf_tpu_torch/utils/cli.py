"""Shared CLI runner with the ``--pdb`` post-mortem option
(counterpart of joint_tensorf_tpu/utils/cli.py:10-28)."""
from __future__ import annotations

import sys
import traceback


def run_cli(main, argv):
    """Invoke ``main(argv)``.  ``--pdb`` is stripped from argv before main
    sees it; with it, an exception prints its traceback, opens a
    post-mortem pdb session on the failing frame, then propagates."""
    use_pdb = "--pdb" in argv
    argv = [a for a in argv if a != "--pdb"]
    if not use_pdb:
        return main(argv)
    try:
        return main(argv)
    except Exception:
        import pdb

        traceback.print_exc()
        print("[pdb] entering post-mortem debugger (--pdb)", file=sys.stderr)
        pdb.post_mortem()
        raise
