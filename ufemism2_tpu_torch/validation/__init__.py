"""Validation tiers: component tests (numerics accuracy), integrated
tests (full-model runs vs analytic/benchmark expectations), and the
scoreboard that records their cost functions per git commit.

Re-design of src/UPSY/validation/ + src/UFEMISM/validation/ +
automated_testing/ (scoreboard scripts)."""

from .scoreboard import ScoreboardRun, read_stability_info
