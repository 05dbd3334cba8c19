"""Traffic drivers (<driver>.py) and mixes (<mix>.json)."""
