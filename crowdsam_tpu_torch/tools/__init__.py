"""The command-line tools, one module each, run as
`python -m crowdsam_tpu_torch.tools.<name>`: `test` (annotate a dataset),
`demo` (annotate a folder), `batch_eval` (annotate, convert, score),
`crowdhuman_eval` (score), `crowdhuman2coco` (convert ground truth).
Counterparts of the JAX package's `tools/*.py`, with their flags; each
`main(argv)` also runs in-process."""
