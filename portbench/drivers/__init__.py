"""One module a driver; a traffic file names its driver by ``"driver"``.

A driver's ``run(r)`` takes the run (``portbench.run.Run``), sets up the
program, measures the window and checks the outputs, and returns a
``portbench.run.Outcome``.
"""
