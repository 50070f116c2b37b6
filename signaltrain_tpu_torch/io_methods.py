"""Reference-API facade for signaltrain.io_methods: plotting and audio I/O.

The reference module also carried a large AudioIO class (ffmpeg / pyglet
playback, io_methods.py:13-394) that nothing used; audio I/O is
``data.audio_io``. The plots are drawn with Pillow (``utils/plots.py``).
"""

from .data.audio_io import read_audio_file, write_audio_file  # noqa: F401
from .utils.plots import plot_spectrograms, plot_valdata  # noqa: F401
