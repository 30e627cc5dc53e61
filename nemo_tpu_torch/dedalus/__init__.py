"""Mini-Dedalus: an executable stand-in for the Molly fault injector.

The reference consumes the output of Molly, an external Scala tool that
model-checks a Dedalus protocol under crash/omission faults and emits per-run
provenance graphs (reference: README.md:5-8).  Molly is not available in this
environment, so this package makes the framework self-contained: a parser and
bottom-up evaluator for the Dedalus subset the case-study protocols use
(deductive rules, @next induction, @async messaging, notin negation,
comparisons, head arithmetic, count<> aggregation), a provenance-capturing
interpreter, a bounded crash/omission fault injector, and a writer producing
Molly-format output directories (runs.json, run_<i>_{pre,post}_provenance.json,
run_<i>_spacetime.dot) that feed straight into nemo_tpu_torch.ingest.molly.
A copy of the JAX package's ``dedalus/``, whose output it matches byte for
byte.

    python -m nemo_tpu_torch.dedalus -program <spec.ded> -EOT 6 -EFF 4 -o out/
"""

from nemo_tpu_torch.dedalus.ast import Atom, Program, Rule, Term
from nemo_tpu_torch.dedalus.parser import parse_program
