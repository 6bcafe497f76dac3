"""Host-side segments and their padded postings layout."""
