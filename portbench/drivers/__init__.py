"""The general drivers that serve a traffic file's mix: `detect` (a closed
loop of batch detection) and `train` (back-to-back training steps)."""
