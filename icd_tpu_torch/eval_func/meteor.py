"""METEOR 1.5 via the upstream Java jar's stdio protocol.

METEOR is alignment-based string processing, so it stays host-side as a
long-lived Java subprocess exactly like the reference (reference:
eval_func/meteor/meteor.py:18-58, 'SCORE'/'EVAL' line protocol guarded by
a lock). The jar is a large external artifact missing from the reference
snapshot itself (.MISSING_LARGE_BLOBS); when it (or a Java runtime) is
unavailable, constructing the scorer RAISES — matching the reference,
whose Java subprocess dies and whose eval crashes rather than writing a
silently wrong ``METEOR: 0.0`` into eval_data JSONs. Set
``ICD_TPU_ALLOW_NO_METEOR=1`` to opt into degrading to 0.0 scores with a
warning instead (used by tests and jar-less smoke runs).

Set METEOR_JAR to point at meteor-1.5.jar (default: this directory), or
METEOR_CMD to a full command line speaking the same stdio protocol
(used by tests and alternative scorer binaries), or
``ICD_TPU_METEOR_PY=1`` to fall back to the in-process pure-Python
METEOR 1.5 (eval_func/meteor_py.py — faithful on the id-string eval
protocol, approximate exact+stem on surface words; see its docstring).

A copy of ``icd_tpu/eval_func/meteor.py``: the port imports
nothing of ``icd_tpu``.
"""

import os
import shlex
import shutil
import subprocess
import threading
import warnings


def _jar_path():
    env = os.environ.get("METEOR_JAR")
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "meteor-1.5.jar")


def _build_command():
    override = os.environ.get("METEOR_CMD")
    if override:
        return shlex.split(override), None
    jar = _jar_path()
    if os.path.exists(jar) and shutil.which("java"):
        return (["java", "-jar", "-Xmx2G", jar,
                 "-", "-", "-stdio", "-l", "en", "-norm"],
                os.path.dirname(jar))
    return None, None


class Meteor:
    def __init__(self):
        self.lock = threading.Lock()
        self.meteor_p = None
        self._py = None
        cmd, cwd = _build_command()
        if cmd is not None:
            self.meteor_p = subprocess.Popen(
                cmd, cwd=cwd,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE)
        elif os.environ.get("ICD_TPU_METEOR_PY"):
            from .meteor_py import MeteorPy

            self._py = MeteorPy()
        elif os.environ.get("ICD_TPU_ALLOW_NO_METEOR"):
            warnings.warn(
                "METEOR jar or Java runtime unavailable; METEOR scores "
                "will be 0.0. Set METEOR_JAR to enable, or "
                "ICD_TPU_METEOR_PY=1 for the pure-Python fallback.",
                stacklevel=2)
        else:
            raise RuntimeError(
                "METEOR jar or Java runtime unavailable (looked for {}). "
                "The reference fails loudly here too "
                "(eval_func/meteor/meteor.py:18-24 launches the jar "
                "unconditionally). Set METEOR_JAR to the meteor-1.5.jar "
                "path, ICD_TPU_METEOR_PY=1 for the pure-Python METEOR "
                "fallback (faithful on the id-string eval protocol — "
                "eval_func/meteor_py.py), or ICD_TPU_ALLOW_NO_METEOR=1 "
                "to accept 0.0 METEOR scores.".format(_jar_path()))

    def compute_score(self, gts, res):
        if self._py is not None:
            return self._py.compute_score(gts, res)
        if self.meteor_p is None:
            return 0.0, [0.0] * len(res)

        scores = []
        eval_line = "EVAL"
        with self.lock:
            for refs, hyp in zip(gts, res):
                assert len(hyp) == 1
                stat = self._stat(hyp[0], refs)
                eval_line += " ||| {}".format(stat)
            self.meteor_p.stdin.write(
                "{}\n".format(eval_line).encode())
            self.meteor_p.stdin.flush()
            for _ in range(len(res)):
                scores.append(
                    float(self.meteor_p.stdout.readline().strip()))
            score = float(self.meteor_p.stdout.readline().strip())
        return score, scores

    def _stat(self, hypothesis_str, reference_list):
        # SCORE ||| ref 1 ||| ... ||| ref n ||| hypothesis
        hypothesis_str = hypothesis_str.replace("|||", "").replace("  ", " ")
        score_line = " ||| ".join(
            ("SCORE", " ||| ".join(reference_list), hypothesis_str))
        self.meteor_p.stdin.write("{}\n".format(score_line).encode())
        self.meteor_p.stdin.flush()
        return self.meteor_p.stdout.readline().decode().strip()

    def method(self):
        return "METEOR"

    def __del__(self):
        if self.meteor_p is not None:
            try:
                with self.lock:
                    self.meteor_p.stdin.close()
                    self.meteor_p.kill()
                    self.meteor_p.wait()
            except Exception:
                pass
