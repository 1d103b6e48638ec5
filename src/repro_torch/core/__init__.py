"""Core layers of the port: threefry, lda, estep, oem, evaluation, serving."""
