"""Evaluation: CrowdHuman AP / MR^-2 / Recall (Caltech matching) and the
format converters (numpy only; this package's own copy of the JAX
package's `evallib`)."""
