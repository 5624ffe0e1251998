// Native FASTA reader of the PyTorch port (host code, not a kernel).
//
// The port's own copy of the JAX package's native/fasta_reader.cpp:
// memory-mapped FASTA parsing (gzip through zlib) with every contig's
// bytes concatenated into one buffer beside its start offset and name.
// Exposed as a C ABI for ctypes.
//
// Built at first use by pyskani_tpu_torch/io/native.py with
//   g++ -O3 -fPIC -shared -std=c++17 fasta_reader.cpp -lz
// into the port's build directory.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

namespace {

struct Genome {
  std::vector<uint8_t> seq;          // concatenated contig bytes
  std::vector<int64_t> contig_starts;  // offsets into seq (one per contig)
  std::vector<std::string> names;
};

// Parse FASTA text from a raw buffer.
void parse_buffer(const uint8_t* data, size_t len, Genome* g,
                  size_t min_contig_len) {
  size_t i = 0;
  std::string name;
  size_t contig_begin = 0;
  bool in_contig = false;

  auto finish_contig = [&]() {
    if (!in_contig) return;
    size_t clen = g->seq.size() - contig_begin;
    if (clen < min_contig_len) {
      // drop short contigs entirely (reference lib.rs:156 semantics)
      g->seq.resize(contig_begin);
      g->names.pop_back();
      g->contig_starts.pop_back();
    }
    in_contig = false;
  };

  while (i < len) {
    if (data[i] == '>') {
      finish_contig();
      size_t j = i + 1;
      while (j < len && data[j] != '\n' && data[j] != '\r') j++;
      size_t name_end = i + 1;
      while (name_end < j && !isspace(data[name_end])) name_end++;
      g->names.emplace_back(reinterpret_cast<const char*>(data + i + 1),
                            name_end - i - 1);
      g->contig_starts.push_back(static_cast<int64_t>(g->seq.size()));
      contig_begin = g->seq.size();
      in_contig = true;
      i = j;
    } else if (data[i] == '\n' || data[i] == '\r') {
      i++;
    } else {
      size_t j = i;
      while (j < len && data[j] != '\n' && data[j] != '\r') j++;
      if (in_contig) {
        g->seq.insert(g->seq.end(), data + i, data + j);
      }
      i = j;
    }
  }
  finish_contig();
}

bool is_gzip(const uint8_t* data, size_t len) {
  return len >= 2 && data[0] == 0x1f && data[1] == 0x8b;
}

}  // namespace

extern "C" {

// Opaque handle
struct FastaGenome {
  Genome g;
};

// Read a FASTA (optionally gzip) file; returns handle or nullptr.
FastaGenome* fasta_read(const char* path, int64_t min_contig_len) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  size_t len = static_cast<size_t>(st.st_size);
  void* map = mmap(nullptr, len, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (map == MAP_FAILED) return nullptr;
  const uint8_t* data = static_cast<const uint8_t*>(map);

  auto* out = new FastaGenome();
  if (is_gzip(data, len)) {
    // stream-decompress then parse
    std::vector<uint8_t> buf;
    buf.reserve(len * 4);
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, 16 + MAX_WBITS) != Z_OK) {
      munmap(map, len);
      delete out;
      return nullptr;
    }
    zs.next_in = const_cast<uint8_t*>(data);
    zs.avail_in = static_cast<uInt>(len);
    std::vector<uint8_t> chunk(1 << 20);
    int ret = Z_OK;
    while (ret != Z_STREAM_END) {
      zs.next_out = chunk.data();
      zs.avail_out = static_cast<uInt>(chunk.size());
      ret = inflate(&zs, Z_NO_FLUSH);
      if (ret != Z_OK && ret != Z_STREAM_END) break;
      buf.insert(buf.end(), chunk.data(),
                 chunk.data() + (chunk.size() - zs.avail_out));
    }
    inflateEnd(&zs);
    munmap(map, len);
    if (ret != Z_STREAM_END) { delete out; return nullptr; }
    parse_buffer(buf.data(), buf.size(), &out->g,
                 static_cast<size_t>(min_contig_len));
  } else {
    parse_buffer(data, len, &out->g, static_cast<size_t>(min_contig_len));
    munmap(map, len);
  }
  return out;
}

int64_t fasta_total_len(const FastaGenome* h) {
  return static_cast<int64_t>(h->g.seq.size());
}

int64_t fasta_num_contigs(const FastaGenome* h) {
  return static_cast<int64_t>(h->g.contig_starts.size());
}

// Copy the concatenated sequence into caller-provided buffer (padded by
// the caller); returns bytes copied.
int64_t fasta_copy_seq(const FastaGenome* h, uint8_t* dst, int64_t cap) {
  int64_t n = std::min<int64_t>(cap, h->g.seq.size());
  memcpy(dst, h->g.seq.data(), static_cast<size_t>(n));
  return n;
}

// Copy contig start offsets (int64) into caller buffer.
int64_t fasta_copy_starts(const FastaGenome* h, int64_t* dst, int64_t cap) {
  int64_t n = std::min<int64_t>(cap, h->g.contig_starts.size());
  memcpy(dst, h->g.contig_starts.data(), static_cast<size_t>(n) * 8);
  return n;
}

// Contig name at index i (NUL-terminated view into the handle).
const char* fasta_contig_name(const FastaGenome* h, int64_t i) {
  if (i < 0 || i >= static_cast<int64_t>(h->g.names.size())) return nullptr;
  return h->g.names[static_cast<size_t>(i)].c_str();
}

void fasta_free(FastaGenome* h) { delete h; }

}  // extern "C"
