// Host FASTA ingest of the PyTorch + CUDA port: parse, validate and
// 2-bit-encode a file in one pass, and assemble the 12-byte junction
// records of the output. Built with g++ at first use by
// twopaco_tpu_torch/io/native.py and bound with ctypes; the numpy parser
// (io/fasta.py) and writer (io/junctions.py) give the same results.
//
// The parser streams the file through an 8 MiB chunk with a 256-entry
// code table, so the only large memory it touches is the caller's codes
// buffer. Semantics are the reference's (streamfastaparser.cpp:29-93):
//   - header = first whitespace-delimited token after '>' (whitespace as
//     the numpy parser's str.split() over latin-1)
//   - whitespace in bodies skipped; chars uppercased via the table
//   - valid chars "ACGTURYKMSWBDHWNXV" (case-insensitive); ACGT -> 0..3,
//     other valid -> 4 (N); anything else -> error
//   - any '>' in a body, even mid-line, starts the next record
//
// C ABI:
//   tp_encode_fasta_into(path, codes, cap, out) -> 0 ok / negative
//   tp_free_result(out) frees the offsets and headers of a result
//   tp_emit_records(chrs, pos, ids, n, now_chr, out) -> bytes written

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct CodeTable {
  uint8_t code[256];
  CodeTable() {
    memset(code, 255, sizeof(code));
    const char* ws = " \t\r\n\v\f";
    for (const char* p = ws; *p; ++p) code[(uint8_t)*p] = 254;
    const char* valid = "ACGTURYKMSWBDHWNXV";
    for (const char* p = valid; *p; ++p) {
      code[(uint8_t)*p] = 4;
      code[(uint8_t)(*p + 32)] = 4;  // lowercase
    }
    const char* lit = "ACGT";
    for (int i = 0; i < 4; ++i) {
      code[(uint8_t)lit[i]] = (uint8_t)i;
      code[(uint8_t)(lit[i] + 32)] = (uint8_t)i;
    }
  }
};
const CodeTable kTable;

// A header's token ends at, and skips, the bytes that Python's str.split()
// takes for whitespace in a latin-1 header line (the numpy parser,
// io/fasta.py): \t \n \v \f \r, 0x1c-0x1f, ' ', 0x85, 0xa0.
bool header_space(uint8_t c) {
  return (c >= 0x09 && c <= 0x0d) || (c >= 0x1c && c <= 0x20) || c == 0x85 ||
         c == 0xa0;
}

// Append the first whitespace-delimited token of a header line (the
// bytes after '>', without the newline) to headers, and its end offset.
void append_header_token(const std::string& line, std::string& headers,
                         std::vector<int64_t>& ends) {
  size_t hs = 0, n = line.size();
  while (hs < n && header_space((uint8_t)line[hs])) ++hs;
  size_t he = hs;
  while (he < n && !header_space((uint8_t)line[he])) ++he;
  headers.append(line, hs, he - hs);
  ends.push_back((int64_t)headers.size());
}

}  // namespace

extern "C" {

struct TpFastaResult {
  uint8_t* codes;        // concatenated encoded bodies
  int64_t codes_len;
  int64_t* rec_offsets;  // n_records+1 offsets into codes
  int64_t n_records;
  char* headers;         // header tokens, concatenated (a token may hold
  int64_t headers_len;   // any byte but whitespace, '\0' included)
  int64_t* header_offsets;  // n_records+1 offsets into headers
  char error[256];
};

// Encode one file into a CALLER-PROVIDED codes buffer (cap bytes; the
// file size is always enough). Streams the file through a small reused
// chunk, so the only large memory touched is the caller's buffer (from
// twopaco_tpu_torch/hostmem.py big_empty: a shared anonymous mapping,
// whose first touch faults faster than private pages on demand-faulted
// hosts). result->codes is left NULL: the caller owns the codes.
// Returns 0 on success; negative with result->error otherwise.
int tp_encode_fasta_into(const char* path, uint8_t* codes, int64_t cap,
                         TpFastaResult* out) {
  memset(out, 0, sizeof(*out));
  FILE* f = fopen(path, "rb");
  if (!f) {
    snprintf(out->error, sizeof(out->error), "Can't open file %s", path);
    return -1;
  }
  const size_t CH = 8 << 20;
  std::vector<uint8_t> buf(CH);
  std::vector<int64_t> offsets;
  std::string headers;
  std::vector<int64_t> header_ends(1, 0);
  std::string hdr_line;
  int64_t n_codes = 0;
  enum { BODY, HEADER } st = BODY;
  bool first = true;
  bool in_any_record = false;
  for (;;) {
    size_t got = fread(buf.data(), 1, CH, f);
    if (got == 0) {
      // distinguish EOF from an I/O error: a transient read failure
      // must not silently truncate the genome (byte-parity invariant)
      if (ferror(f)) {
        fclose(f);
        snprintf(out->error, sizeof(out->error),
                 "Short read (I/O error) in %s", path);
        return -2;
      }
      break;
    }
    size_t i = 0;
    if (first) {
      if (buf[0] != '>') {
        fclose(f);
        snprintf(out->error, sizeof(out->error),
                 "The FASTA header should start with a '>'");
        return -3;
      }
      first = false;
    }
    while (i < got) {
      if (st == HEADER) {
        size_t j = i;
        while (j < got && buf[j] != '\n') ++j;
        hdr_line.append((const char*)buf.data() + i, j - i);
        i = j;
        if (i < got) {  // newline: header line complete, body starts
          ++i;
          append_header_token(hdr_line, headers, header_ends);
          offsets.push_back(n_codes);
          st = BODY;
        }
        continue;
      }
      // BODY (or before the first record): next record at any '>',
      // even mid-line (reference streamfastaparser.cpp:73-77)
      const uint8_t* gt =
          (const uint8_t*)memchr(buf.data() + i, '>', got - i);
      size_t stop = gt ? (size_t)(gt - buf.data()) : got;
      if (in_any_record) {
        if (n_codes + (int64_t)(stop - i) > cap) {
          fclose(f);
          snprintf(out->error, sizeof(out->error),
                   "codes buffer too small (%lld)", (long long)cap);
          return -5;
        }
        uint8_t bad = 0;
        int64_t n = n_codes;
        for (size_t j = i; j < stop; ++j) {
          uint8_t c = kTable.code[buf[j]];
          codes[n] = c;
          n += (c < 5);  // branchless append; 254 (ws) overwritten
          bad |= (uint8_t)(c == 255);
        }
        if (bad) {
          for (size_t j = i; j < stop; ++j) {
            if (kTable.code[buf[j]] == 255) {
              snprintf(out->error, sizeof(out->error),
                       "Found an invalid character '%c' in %s",
                       buf[j], path);
              break;
            }
          }
          fclose(f);
          return -4;
        }
        n_codes = n;
      }
      i = stop;
      if (gt) {  // start of the next record
        ++i;
        st = HEADER;
        hdr_line.clear();
        in_any_record = true;
      }
    }
  }
  fclose(f);
  if (st == HEADER) {  // EOF inside the header line: empty body
    append_header_token(hdr_line, headers, header_ends);
    offsets.push_back(n_codes);
  }
  offsets.push_back(n_codes);
  out->codes = NULL;  // caller-owned
  out->codes_len = n_codes;
  out->n_records = (int64_t)offsets.size() - 1;
  out->rec_offsets = (int64_t*)malloc(offsets.size() * sizeof(int64_t));
  memcpy(out->rec_offsets, offsets.data(),
         offsets.size() * sizeof(int64_t));
  out->headers_len = (int64_t)headers.size();
  out->headers = (char*)malloc(headers.size() ? headers.size() : 1);
  memcpy(out->headers, headers.data(), headers.size());
  out->header_offsets = (int64_t*)malloc(header_ends.size() * sizeof(int64_t));
  memcpy(out->header_offsets, header_ends.data(),
         header_ends.size() * sizeof(int64_t));
  return 0;
}

void tp_free_result(TpFastaResult* r) {
  free(r->codes);
  free(r->rec_offsets);
  free(r->headers);
  free(r->header_offsets);
  memset(r, 0, sizeof(*r));
}

// 12-byte junction records (uint32 pos + int64 id, little-endian) with
// separator records auto-inserted at chromosome increments — exactly
// the reference JunctionPositionWriter (junctionapi.h:118-132). `out`
// must hold 12 * (n + chrs[n-1] - now_chr) bytes; returns bytes
// written. One pass instead of numpy's strided scatter + copy chain.
int64_t tp_emit_records(const int64_t* chrs, const uint32_t* pos,
                        const int64_t* ids, int64_t n, int64_t now_chr,
                        uint8_t* out) {
  uint8_t* p = out;
  int64_t cur = now_chr;
  const uint32_t sep_pos = 0xFFFFFFFFu;
  const int64_t sep_id = INT64_MAX;
  for (int64_t i = 0; i < n; ++i) {
    for (; cur < chrs[i]; ++cur) {
      memcpy(p, &sep_pos, 4);
      memcpy(p + 4, &sep_id, 8);
      p += 12;
    }
    memcpy(p, &pos[i], 4);
    memcpy(p + 4, &ids[i], 8);
    p += 12;
  }
  return (int64_t)(p - out);
}

}  // extern "C"
