# Checkpoints (the serving session resumes from them).
