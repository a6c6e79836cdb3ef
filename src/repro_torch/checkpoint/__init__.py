"""PCache checkpoints and Babel cross-cluster sync (own copies of
`repro.checkpoint`)."""
