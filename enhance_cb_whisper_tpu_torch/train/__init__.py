"""Paper-1 KWS training: the train step and its optimizer."""
