"""One reader per metric base name: `read(run, suffix)` returns the
metric's value from the run's records (see harness.run_cell), or None
where the run has nothing for it to read.  A suffix ('train', 'eval')
names the kind of cell the metric belongs to."""
