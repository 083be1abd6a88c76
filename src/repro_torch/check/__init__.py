"""``repro_torch.check``: the design-rule verifier of the port.

Port of the JAX package's ``check`` package.  Three layers behind one
:class:`Finding` / :class:`CheckReport` API:

* **plan rules** (:mod:`repro_torch.check.plan_rules`): decode a plan or
  fleet artifact and verify the invariants the planner is meant to keep
  (layer chain, tile legality, fusion groups and their shared memory,
  boundary structure, the latency decomposition, serve-section keys, fleet
  budgets), with no execution.
* **kernel contracts** (:mod:`repro_torch.check.kernel_contracts`): each
  planned launch's arguments put through its wrapper's own contract function
  on meta tensors (no device work), and a library self-check that launches
  every ported kernel once on a canonical case.
* **hazard lint** (:mod:`repro_torch.check.lint`): stdlib-``ast`` rules
  over ``src/repro_torch``: host syncs in the serving hot paths, Python
  ``if`` on tensors and clocks or host RNG in CUDA-graph-captured code,
  shared state mutated outside its lock, dict-order-dependent hashing.

:func:`check_tree` runs them over a checkout: the lint, every plan
artifact under ``deployments_torch/`` and every ``bench/**/BENCH_*.json``
snapshot (:func:`check_snapshot`).  The deploy gate is
``Deployment.build(check=True)`` (fail-closed before any engine); the CLI
is ``python -m repro_torch check``.  Exit codes:

* ``0``: clean (warnings and info findings do not fail the check);
* ``1``: at least one error finding;
* ``2``: an artifact that cannot be decoded (:class:`ArtifactError`,
  reported in one line on stderr).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

SEVERITIES = ("error", "warning", "info")

EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_UNDECODABLE = 2


class ArtifactError(Exception):
    """An artifact that cannot be decoded as a plan or fleet at all
    (unreadable, malformed JSON, unsupported schema, missing sections)."""


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation (or advisory).  ``rule`` is the stable dotted id
    (``plan.tile-legal``, ``kernel.smem-scratch``, ...); ``tenant`` the
    fleet tenant; ``layer`` the layer index when the finding is that
    specific."""

    rule: str
    severity: str                       # "error" | "warning" | "info"
    detail: str
    tenant: str | None = None
    layer: int | None = None

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {self.severity!r}")

    def to_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "tenant": self.tenant, "layer": self.layer,
                "detail": self.detail}

    def __str__(self) -> str:
        where = self.tenant or "-"
        if self.layer is not None:
            where += f":{self.layer}"
        return f"[{self.severity:<7}] {self.rule:<24} {where:<28} {self.detail}"


@dataclasses.dataclass
class CheckReport:
    """All findings of one check run, what was checked, the kernel launches
    the library self-check made, and the exit-code logic."""

    findings: list = dataclasses.field(default_factory=list)
    checked: list = dataclasses.field(default_factory=list)
    launches: dict = dataclasses.field(default_factory=dict)

    def extend(self, findings) -> "CheckReport":
        self.findings.extend(findings)
        return self

    def errors(self) -> list:
        return [f for f in self.findings if f.severity == "error"]

    def counts(self) -> dict:
        out = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            out[f.severity] += 1
        return out

    @property
    def exit_code(self) -> int:
        return EXIT_FINDINGS if self.errors() else EXIT_CLEAN

    def to_dict(self) -> dict:
        return {"version": 1, "checked": list(self.checked),
                "counts": self.counts(), "launches": dict(self.launches),
                "findings": [f.to_dict() for f in self.findings]}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def __str__(self) -> str:
        if not self.findings:
            return "check: clean (no findings)"
        c = self.counts()
        return "\n".join([str(f) for f in self.findings] + [
            f"check: {len(self.findings)} finding(s) ({c['error']} error, "
            f"{c['warning']} warning, {c['info']} info)"])


class PlanVerificationError(Exception):
    """A plan failed verification at deploy time (the fail-closed verify
    stage of ``Deployment.build``).  Carries the findings."""

    def __init__(self, findings):
        self.findings = list(findings)
        errs = [f for f in self.findings if f.severity == "error"]
        super().__init__(
            f"{len(errs)} design-rule violation(s): "
            + "; ".join(f"{f.rule} ({f.tenant or '-'})" for f in errs[:4])
            + ("; ..." if len(errs) > 4 else ""))


def check_fleet(fleet, *, hw=None, aie=None, kernels: bool = True) -> list:
    """All plan-rule and kernel-contract findings for one ``FleetPlan`` (or
    a bare ``DeploymentPlan``, taken as a one-tenant fleet).  ``hw`` is the
    card's machine model (default ``hw.H100_SXM``), ``aie`` the AIE
    array's (default ``hw.AIE_ML``).  The kernel contracts run for the
    card's plans only: an AIE plan names no kernel of the port.  Does no
    device work."""
    from repro_torch.check import kernel_contracts, plan_rules
    fleet = plan_rules.as_fleet(fleet)
    findings = plan_rules.verify_fleet(fleet, hw=hw, aie=aie)
    if kernels:
        for t in fleet.tenants:
            if t.plan.target != "aie":
                findings += kernel_contracts.verify_plan_kernels(
                    t.plan, tenant=t.net_id, hw=hw)
    return findings


def check_artifact(path, *, hw=None, aie=None, kernels: bool = True) -> list:
    """Decode one plan or fleet artifact and verify it.  Undecodable input
    raises :class:`ArtifactError`."""
    from repro_torch.check import plan_rules
    fleet, findings = plan_rules.load_artifact(path)
    return findings + check_fleet(fleet, hw=hw, aie=aie, kernels=kernels)


def check_snapshot(path) -> list:
    """Validate one BENCH snapshot in the reference's strict shape: a JSON
    object whose ``rows`` are ``{name, us_per_call}`` objects with
    non-negative numbers.  Undecodable -> :class:`ArtifactError`."""
    p = pathlib.Path(path)
    try:
        text = p.read_text()
    except OSError as e:
        raise ArtifactError(f"{p}: {e.strerror or e}") from None
    try:
        payload = json.loads(text)
    except json.JSONDecodeError as e:
        raise ArtifactError(f"{p}: malformed snapshot JSON "
                            f"({e.msg} at line {e.lineno})") from None
    if not isinstance(payload, dict):
        raise ArtifactError(f"{p}: snapshot must be a JSON object, "
                            f"got {type(payload).__name__}")
    rows = payload.get("rows", [])
    if not isinstance(rows, list) or any(
            not isinstance(r, dict) or "name" not in r
            or "us_per_call" not in r for r in rows):
        raise ArtifactError(f"{p}: 'rows' must be a list of "
                            f"{{name, us_per_call}} objects")
    findings = []
    if not rows:
        findings.append(Finding(
            rule="snapshot.empty", severity="warning", tenant=str(p),
            detail="snapshot has no rows - nothing to trend-gate"))
    for i, r in enumerate(rows):
        v = r["us_per_call"]
        if not isinstance(v, (int, float)) or isinstance(v, bool) \
                or v != v or v < 0:
            findings.append(Finding(
                rule="snapshot.row-value", severity="error", tenant=str(p),
                layer=i,
                detail=f"row {r['name']!r}: us_per_call must be a "
                       f"non-negative number, got {v!r}"))
    return findings


#: The port's deploy directory: ``python -m repro_torch deploy`` writes its
#: artifacts there, as the reference's writes ``deployments/``.
DEPLOY_DIR = "deployments_torch"


def check_tree(root=".", *, kernels: bool = True,
               lint: bool = True) -> CheckReport:
    """The whole-tree check of a checkout at ``root``: lint
    ``src/repro_torch``, verify every plan artifact under
    ``deployments_torch/``, validate every ``bench/**/BENCH_*.json``
    snapshot.  Undecodable input raises :class:`ArtifactError`."""
    from repro_torch.check import lint as lint_mod
    root = pathlib.Path(root)
    report = CheckReport()
    if lint:
        src = root / "src" / "repro_torch"
        if src.is_dir():
            files = sorted(src.rglob("*.py"))
            report.extend(lint_mod.lint_paths(files))
            report.checked.append(f"lint:{len(files)} files")
    deploy = root / DEPLOY_DIR
    for p in sorted(deploy.glob("*.json")) if deploy.is_dir() else []:
        report.extend(check_artifact(p, kernels=kernels))
        report.checked.append(f"plan:{p.name}")
    bench = root / "bench"
    for p in sorted(bench.rglob("BENCH_*.json")) if bench.is_dir() else []:
        report.extend(check_snapshot(p))
        report.checked.append(f"snapshot:{p.name}")
    return report
