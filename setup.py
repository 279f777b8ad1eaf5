"""Build-time commit stamping (parity with the reference's
build-common/cmake/VersionHelper.cmake:1-8, which bakes `git describe`
into version.h).  Wheels/sdists built from a git checkout carry
somatic_sniper_tpu/_commit.py and somatic_sniper_tpu_torch/_commit.py;
each package's cli.main._commit_id() reads its own, falling back to a
live git query for editable installs."""

import os
import subprocess

from setuptools import setup
from setuptools.command.build_py import build_py


class BuildPyWithCommit(build_py):
    def run(self):
        super().run()
        try:
            c = subprocess.run(
                ["git", "rev-parse", "--short=8", "HEAD"],
                capture_output=True, text=True, timeout=10,
                cwd=os.path.dirname(os.path.abspath(__file__)) or ".",
            ).stdout.strip()
        except Exception:
            c = ""
        if c:
            for pkg in ("somatic_sniper_tpu", "somatic_sniper_tpu_torch"):
                path = os.path.join(self.build_lib, pkg, "_commit.py")
                with open(path, "w") as fh:
                    fh.write(f'COMMIT = "{c}"\n')


setup(cmdclass={"build_py": BuildPyWithCommit})
